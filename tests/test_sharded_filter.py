"""Tensor-parallel (covariance-sharded) EKF step: correctness vs the
single-device path on an 8-virtual-device ('data' x 'model') mesh, plus
the HLO guarantee that no D x D tensor ever crosses the mesh.

The reference has no model parallelism anywhere (SURVEY.md §2.8); this is
the capacity-scaling path (parallel/sharded_filter.py).
"""

import jax
import jax.numpy as jnp
import numpy as np

from ekf_slam_tpu.config import EngineConfig, MapConfig, SimConfig
from ekf_slam_tpu.filter import engine
from ekf_slam_tpu.filter.state import init_state
from ekf_slam_tpu.parallel import sharded_filter as sf
from ekf_slam_tpu.parallel.mesh import make_mesh
from ekf_slam_tpu.sim import scene as sim_scene


def tp_cfg():
    return EngineConfig(
        map=MapConfig(capacity=12, min_features_in_image=6,
                      max_new_per_step=6),
        sim=SimConfig(num_landmarks=16),
        dtype="float32")


def _setup(cfg, B, T):
    scn, xs, obs = sim_scene.simulate(jax.random.key(0), cfg, T)
    obs0 = jax.tree.map(lambda a: a[0], obs)
    st = engine.bootstrap(init_state(cfg), obs0, cfg)
    st_b = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), st)
    frame_keys = [jax.random.split(jax.random.key(100 + t), B)
                  for t in range(1, T)]
    return st_b, obs, frame_keys


def test_tp_step_matches_single_device():
    cfg = tp_cfg()
    B, T = 4, 4
    mesh = make_mesh(data=2, model=4)
    D, Dp = sf.padded_dim(cfg, 4)
    assert D == 13 + 6 * 12 and Dp % 4 == 0 and Dp >= D

    st_b, obs, frame_keys = _setup(cfg, B, T)

    # Reference: plain vmapped step on one device.
    ref_step = jax.jit(jax.vmap(
        lambda s, o, k: engine.step(s, o, k, cfg), in_axes=(0, None, 0)))
    ref = st_b
    for t in range(1, T):
        obs_t = jax.tree.map(lambda a: a[t], obs)
        ref, ref_info = ref_step(ref, obs_t, frame_keys[t - 1])

    # Tensor-parallel: P rows sharded 4-way, batch sharded 2-way.
    step = sf.make_sharded_step(cfg, mesh)
    sharded = sf.shard_state_batch(st_b, mesh, cfg)
    for t in range(1, T):
        obs_t = jax.tree.map(lambda a: a[t], obs)
        sharded, info = step(sharded, obs_t, frame_keys[t - 1])

    # Per-device covariance shard is (B/2, Dp/4, Dp): capacity memory
    # scales down with the model axis.
    shard_shapes = {s.data.shape for s in sharded.P.addressable_shards}
    assert shard_shapes == {(B // 2, Dp // 4, Dp)}

    out = sf.unpad_state(jax.device_get(sharded), D)
    np.testing.assert_allclose(np.asarray(out.x), np.asarray(ref.x),
                               rtol=0, atol=2e-4)
    np.testing.assert_allclose(np.asarray(out.P), np.asarray(ref.P),
                               rtol=1e-3, atol=2e-3)
    # Discrete pipeline decisions (gates, picks, management) are identical.
    for f in ("active", "cartesian", "landmark_id", "times_measured"):
        np.testing.assert_array_equal(np.asarray(getattr(out, f)),
                                      np.asarray(getattr(ref, f)))
    # Pad block stayed exactly zero.
    P_pad = np.asarray(jax.device_get(sharded.P))
    assert np.all(P_pad[:, D:, :] == 0) and np.all(P_pad[:, :, D:] == 0)
    assert np.all(np.asarray(jax.device_get(sharded.x))[:, D:] == 0)


def test_tp_step_collectives_stay_small():
    """The compiled TP step must not move any D x D tensor over the mesh:
    every collective's payload is factor-class — O(D * rows) where rows
    is one of the step's tall-skinny factor widths (feature-add factor
    12*max_new, folded-tail factor 2M+8, RANSAC hypothesis factor NHYP) —
    never the O(D*D) covariance itself."""
    cfg = tp_cfg()
    B, n_model = 4, 4
    mesh = make_mesh(data=2, model=n_model)
    D, Dp = sf.padded_dim(cfg, n_model)
    st_b, obs, frame_keys = _setup(cfg, B, 2)
    obs1 = jax.tree.map(lambda a: a[1], obs)

    step = sf.make_sharded_step(cfg, mesh)
    sharded = sf.shard_state_batch(st_b, mesh, cfg)
    txt = step.lower(sharded, obs1, frame_keys[0]).compile().as_text()

    colls = sf.collective_inventory(txt)
    assert colls, "expected the TP step to contain mesh collectives"
    b_local = B // mesh.shape["data"]
    factor_rows = max(12 * cfg.map.max_new_per_step,        # add factor G
                      4 * cfg.map.capacity + 8,             # tail 2M+8
                      cfg.ransac.num_hypotheses)            # gform apply
    limit = b_local * Dp * factor_rows
    assert limit < b_local * Dp * D, "bound must stay below full-P size"
    for line in colls:
        assert sf.collective_payload(line) <= limit, \
            f"covariance-sized collective: {line}"


def test_tp_step_pure_model_mesh():
    """model=8, data=1: the covariance shards 8-way on a single-instance
    batch and still matches the single-device step."""
    cfg = tp_cfg()
    B, T = 1, 3
    mesh = make_mesh(data=1, model=8)
    D, Dp = sf.padded_dim(cfg, 8)
    st_b, obs, frame_keys = _setup(cfg, B, T)

    ref_step = jax.jit(jax.vmap(
        lambda s, o, k: engine.step(s, o, k, cfg), in_axes=(0, None, 0)))
    step = sf.make_sharded_step(cfg, mesh)
    sharded = sf.shard_state_batch(st_b, mesh, cfg)
    ref = st_b
    for t in range(1, T):
        obs_t = jax.tree.map(lambda a: a[t], obs)
        sharded, _ = step(sharded, obs_t, frame_keys[t - 1])
        ref, _ = ref_step(ref, obs_t, frame_keys[t - 1])

    assert {s.data.shape for s in sharded.P.addressable_shards} \
        == {(1, Dp // 8, Dp)}
    out = sf.unpad_state(jax.device_get(sharded), D)
    np.testing.assert_allclose(np.asarray(out.x), np.asarray(ref.x),
                               rtol=0, atol=2e-4)
    np.testing.assert_allclose(np.asarray(out.P), np.asarray(ref.P),
                               rtol=1e-3, atol=2e-3)
