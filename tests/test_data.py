"""Data pipeline tests: class taxonomy, record shards, synthetic batches."""

import numpy as np

from ekf_slam_tpu.data import synthetic_batch, class_weights
from ekf_slam_tpu.data.classes import (CALC_CLASSES, CALC_CLASS_NAMES,
                                       COCO_TO_CALC, N_CALC_CLASSES,
                                       coco_to_calc_lut)
from ekf_slam_tpu.data.records import ShardReader, load_weights, write_shards

import jax


def test_class_tables():
    assert N_CALC_CLASSES == 13
    assert CALC_CLASS_NAMES[0] == "background"
    assert CALC_CLASSES["sky"] == 8
    # every COCO-stuff id 0..92 maps somewhere
    assert set(COCO_TO_CALC) == set(range(93))
    lut = coco_to_calc_lut()
    assert lut.shape == (93,)
    assert lut[15] == CALC_CLASSES["sky"]          # clouds -> sky
    assert lut[5] == CALC_CLASSES["building"]      # building-other
    assert lut[64] == CALC_CLASSES["water"]        # sea


def test_records_roundtrip(tmp_path):
    rng = np.random.default_rng(0)

    def pairs():
        for _ in range(10):
            img = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
            lab = rng.integers(0, 13, (32, 32), dtype=np.uint8)
            yield img, lab

    n = write_shards(str(tmp_path), pairs(), shard_size=4)
    assert n >= 2
    w = load_weights(str(tmp_path))
    assert w.shape == (13,) and np.all(w > 0)

    reader = ShardReader(str(tmp_path), batch_size=2)
    x, y = next(iter(reader))
    assert x.shape == (2, 32, 32, 3) and x.max() <= 1.0
    assert y.shape == (2, 32, 32, 13)
    np.testing.assert_allclose(y.sum(-1), 1.0)


def test_synthetic_batch_structure():
    imgs, labels = synthetic_batch(jax.random.key(0), 2, (32, 32))
    assert imgs.shape == (2, 32, 32, 3)
    assert labels.shape == (2, 32, 32, 13)
    w = class_weights(labels)
    assert w.shape == (13,)


def test_shards_feed_training(tmp_path):
    """Record shards -> ShardReader -> train.fit integration (the
    gen_tfrecords -> estimator input_fn pipeline, end to end)."""
    import jax.numpy as jnp
    from ekf_slam_tpu.models import train
    from ekf_slam_tpu.models.vss import VSSConfig

    rng = np.random.default_rng(1)

    def pairs():
        for _ in range(4):
            yield (rng.integers(0, 256, (32, 32, 3), dtype=np.uint8),
                   rng.integers(0, 13, (32, 32), dtype=np.uint8))

    write_shards(str(tmp_path), pairs(), shard_size=4)
    reader = ShardReader(str(tmp_path), batch_size=2)
    model = train.create_model(VSSConfig(width=8))
    tcfg = train.TrainConfig(batch_size=2, image_hw=(32, 32))
    state, metrics = train.fit(model, tcfg, iter(reader), num_steps=2)
    assert int(state.step) == 2
    assert bool(jnp.isfinite(metrics["loss"]))


def test_aliased_places_structure():
    """Aliased place sets: same-archetype places are near-duplicates in
    pixel space (the perceptual-aliasing regime), cross-archetype are not,
    and every place still differs from its archetype siblings."""
    from ekf_slam_tpu.data.synthetic import aliased_places
    imgs, labels, arch = aliased_places(jax.random.key(3), 16, group=4,
                                        hw=(48, 64))
    assert imgs.shape == (16, 48, 64, 3)
    assert labels.shape == (16, 48, 64, 13)
    np.testing.assert_array_equal(np.asarray(arch), np.repeat(
        np.arange(4), 4))
    flat = np.asarray(imgs).reshape(16, -1)
    flat = flat - flat.mean(-1, keepdims=True)
    flat /= np.linalg.norm(flat, axis=-1, keepdims=True)
    sim = flat @ flat.T
    a = np.asarray(arch)
    eye = np.eye(16, dtype=bool)
    same = (a[:, None] == a[None, :]) & ~eye
    cross = a[:, None] != a[None, :]
    # Near-duplicate within an archetype, distinct across.
    assert sim[same].mean() > 0.7, sim[same].mean()
    assert sim[same].mean() > sim[cross].mean() + 0.5
    # ...but no two places are pixel-identical (identity survives).
    assert sim[same].max() < 0.999


def test_val_shards_embedded_eval_pairs(tmp_path):
    """write_val_shards/load_eval_pairs round trip + evaluate_pairs on
    the reloaded pairs equals evaluating the in-memory arrays — the
    shard-embedded-eval contract of gen_tfrecords.py:81-88,147-149
    """
    import jax
    import jax.numpy as jnp
    from ekf_slam_tpu.data.records import load_eval_pairs, write_val_shards
    from ekf_slam_tpu.models import evaluate, train
    from ekf_slam_tpu.models.augment import eval_view
    from ekf_slam_tpu.models.vss import VSSConfig

    hw = (32, 32)
    n = 6
    mem, labels = synthetic_batch(jax.random.key(0), n, hw)
    live = eval_view(jax.random.key(1), mem)
    cls = np.asarray(jnp.argmax(labels, -1)).astype(np.uint8)
    mem_u8 = np.asarray(mem * 255.0).astype(np.uint8)
    live_u8 = np.asarray(live * 255.0).astype(np.uint8)

    def examples():
        for i in range(n):
            yield mem_u8[i], cls[i], live_u8[i], mem_u8[i]

    n_shards = write_val_shards(str(tmp_path), examples(), shard_size=4)
    assert n_shards == 2
    live_r, mem_r = load_eval_pairs(str(tmp_path))
    assert live_r.shape == (n, *hw, 3) and mem_r.shape == (n, *hw, 3)
    np.testing.assert_allclose(live_r, live_u8.astype(np.float32) / 255.0)

    model = train.create_model(VSSConfig(width=4))
    st = train.init_state(model, train.TrainConfig(batch_size=2,
                                                   image_hw=hw),
                          jax.random.key(2))
    variables = {"params": st.params, "batch_stats": st.batch_stats}
    out_direct = evaluate.evaluate_pairs(
        model, variables, jnp.asarray(live_u8, jnp.float32) / 255.0,
        jnp.asarray(mem_u8, jnp.float32) / 255.0, batch=2)
    out_shard = evaluate.evaluate_pairs(
        model, variables, jnp.asarray(live_r), jnp.asarray(mem_r), batch=2)
    assert out_shard["auc"] == out_direct["auc"]
