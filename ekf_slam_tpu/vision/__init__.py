"""Image front-end (the reference's CV-toolbox replacement, SURVEY.md §2.5).

The reference leans on compiled MATLAB CV-toolbox primitives —
detectFASTFeatures / extractFeatures(FREAK) / matchFeatures
(matching.m:29-47, initialize_a_feature.m:29-54) — and keeps a legacy NCC
path (crosscorr.m). This package provides fixed-shape equivalents as
batched jnp ops:

* fast.py       — FAST-16 corner score + non-max suppression
* descriptor.py — binary intensity-comparison descriptor (FREAK-class)
* ncc.py        — normalized cross-correlation patch matching over the
                  chi^2-gated search ellipse
* patch_warp.py — homography patch-appearance prediction (pred_patch_fc)
* frontend.py   — ties detection/matching into the engine's (z, z_valid)
                  measurement interface
"""
