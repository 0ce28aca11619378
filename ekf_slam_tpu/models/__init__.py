"""Loop-closure model family (the reference's "CALC 2.0" subsystem, L6-L8).

* vss.py         — Variational Semantic Segmentator (Flax), the CALC2 network
* augment.py     — differentiable random-homography augmentation
* losses.py      — triplet / segmentation / reconstruction / KLD losses +
                   in-batch hard-negative mining
* train.py       — optax train step with data-parallel mesh sharding
* keypoints.py   — conv-activation keypoints + local descriptors
* loopclosure.py — descriptor database, cosine-similarity retrieval,
                   temporal consistency, loop-constraint emission
"""
