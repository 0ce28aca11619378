"""Executed contract for the COCO-Stuff adapter.

Builds a miniature COCO-Stuff-format dataset IN-TEST — two small PNG
images and annotations covering all three segmentation encodings
(polygon, uncompressed RLE, compressed-string RLE) — then runs the full
reference-equivalent chain with no network and no pycocotools:

    coco_pairs -> write_shards -> load_weights -> ShardReader
               -> one models.train.train_step

Reference: "CALC 2.0"/dataset/gen_tfrecords.py:41-167 (tfrecord builder),
dataset/coco.py:60-199 (annotation loading). The RLE string codec is
additionally pinned by an encode/decode round trip and against a
hand-computed mask.
"""

import json
import os

import numpy as np
import pytest

from ekf_slam_tpu.data import coco_min
from ekf_slam_tpu.data.classes import N_CALC_CLASSES
from ekf_slam_tpu.data.coco import coco_pairs
from ekf_slam_tpu.data.records import ShardReader, load_weights, write_shards


def test_rle_string_roundtrip():
    rng = np.random.default_rng(0)
    for _ in range(20):
        n = int(rng.integers(1, 12))
        counts = rng.integers(0, 2000, size=n).tolist()
        s = coco_min.rle_encode(counts)
        assert coco_min.rle_decode(s) == counts


def test_rle_mask_roundtrip():
    rng = np.random.default_rng(1)
    mask = (rng.random((17, 23)) < 0.3).astype(np.uint8)
    counts = coco_min.mask_to_counts(mask)
    back = coco_min.counts_to_mask(counts, 17, 23)
    np.testing.assert_array_equal(back, mask)


def test_counts_to_mask_column_major():
    # 3x2, counts [1, 2, 3]: column-major pixels = [0, 1, 1, 0, 0, 0]
    m = coco_min.counts_to_mask([1, 2, 3], 3, 2)
    np.testing.assert_array_equal(
        m, np.array([[0, 0], [1, 0], [1, 0]], np.uint8))


def _write_fixture(root):
    """Two images; three annotations: polygon, uncompressed RLE,
    compressed RLE. Category ids use the COCO-Stuff convention (stuff
    ids start at 92; the adapter subtracts stuff_id_offset=91)."""
    from PIL import Image

    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(7)
    sizes = {"a.png": (24, 30), "b.png": (28, 22)}  # (h, w)
    for name, (h, w) in sizes.items():
        Image.fromarray(
            rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
        ).save(os.path.join(img_dir, name))

    # image a: polygon (category 93 -> stuff idx 2) + uncompressed RLE
    # (category 95 -> idx 4). image b: compressed RLE (category 96 -> 5).
    ha, wa = sizes["a.png"]
    hb, wb = sizes["b.png"]
    rle_mask_a = np.zeros((ha, wa), np.uint8)
    rle_mask_a[2:9, 1:5] = 1
    rle_mask_b = np.zeros((hb, wb), np.uint8)
    rle_mask_b[10:, 8:15] = 1
    ann = {
        "images": [
            {"id": 1, "file_name": "a.png", "height": ha, "width": wa},
            {"id": 2, "file_name": "b.png", "height": hb, "width": wb},
        ],
        "annotations": [
            {"id": 10, "image_id": 1, "category_id": 93,
             "segmentation": [[6.0, 3.0, 25.0, 3.0, 25.0, 20.0, 6.0, 20.0]]},
            {"id": 11, "image_id": 1, "category_id": 95,
             "segmentation": {
                 "size": [ha, wa],
                 "counts": coco_min.mask_to_counts(rle_mask_a)}},
            {"id": 12, "image_id": 2, "category_id": 96,
             "segmentation": {
                 "size": [hb, wb],
                 "counts": coco_min.rle_encode(
                     coco_min.mask_to_counts(rle_mask_b))}},
        ],
    }
    ann_path = os.path.join(root, "stuff_ann.json")
    with open(ann_path, "w") as f:
        json.dump(ann, f)
    return ann_path, img_dir, rle_mask_a, rle_mask_b


def test_minicoco_ann_to_mask(tmp_path):
    ann_path, img_dir, rle_a, rle_b = _write_fixture(str(tmp_path))
    coco = coco_min.MiniCOCO(ann_path)
    assert coco.getImgIds() == [1, 2]
    assert coco.getAnnIds(1) == [10, 11]
    poly_m = coco.annToMask(coco.loadAnns(10)[0])
    assert poly_m.shape == (24, 30)
    assert poly_m[10, 10] == 1 and poly_m[0, 0] == 0  # interior / exterior
    np.testing.assert_array_equal(
        coco.annToMask(coco.loadAnns(11)[0]), rle_a)
    np.testing.assert_array_equal(
        coco.annToMask(coco.loadAnns(12)[0]), rle_b)


def test_coco_pairs_to_one_train_step(tmp_path):
    """The full never-before-executed chain, end to end on tiny shapes."""
    import jax
    import jax.numpy as jnp

    from ekf_slam_tpu.models import train as mtrain
    from ekf_slam_tpu.models.vss import VSSConfig

    ann_path, img_dir, _, _ = _write_fixture(str(tmp_path))
    pairs = list(coco_pairs(ann_path, img_dir, size=(32, 32)))
    assert len(pairs) == 2
    for img, mask in pairs:
        assert img.shape == (32, 32, 3) and img.dtype == np.uint8
        assert mask.shape == (32, 32) and mask.dtype == np.uint8
        assert mask.max() < N_CALC_CLASSES
        assert mask.max() > 0  # relabeling produced non-background ids

    shard_dir = str(tmp_path / "shards")
    n = write_shards(shard_dir, iter(pairs), shard_size=2)
    assert n == 1
    weights = load_weights(shard_dir)
    assert weights.shape == (N_CALC_CLASSES,)
    assert np.all(np.isfinite(weights)) and np.all(weights > 0)

    reader = ShardReader(shard_dir, batch_size=2, prefetch=0)
    x, y = next(iter(reader))
    assert x.shape == (2, 32, 32, 3) and y.shape == (2, 32, 32, 13)

    model = mtrain.create_model(VSSConfig(width=4))
    tcfg = mtrain.TrainConfig(batch_size=2, image_hw=(32, 32))
    state = mtrain.init_state(model, tcfg, jax.random.key(0))
    state2, metrics = jax.jit(
        lambda s, xx, yy, ww, k: mtrain.train_step(
            model, tcfg, s, xx, yy, ww, k))(
        state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(weights),
        jax.random.key(1))
    assert int(state2.step) == 1
    assert np.isfinite(float(metrics["loss"]))


if __name__ == "__main__":
    pytest.main([__file__, "-q"])
