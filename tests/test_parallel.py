"""Mesh utilities + sharded Monte-Carlo ensemble on the 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ekf_slam_tpu.config import CAM_DIM, EngineConfig, MapConfig, SimConfig
from ekf_slam_tpu.filter import engine
from ekf_slam_tpu.filter.state import init_state
from ekf_slam_tpu.parallel import make_mesh, run_ensemble, shard_batch
from ekf_slam_tpu.sim import scene as sim_scene


def test_make_mesh_shapes():
    m1 = make_mesh()
    assert m1.axis_names == ("data",)
    assert m1.devices.shape == (8,)
    m2 = make_mesh(data=4, model=2)
    assert m2.axis_names == ("data", "model")
    assert m2.devices.shape == (4, 2)


def test_shard_batch_places_on_mesh():
    mesh = make_mesh()
    x = jnp.zeros((16, 5))
    xs = shard_batch(x, mesh)
    assert len(xs.sharding.device_set) == 8


def test_run_ensemble_sharded():
    cfg = EngineConfig(
        map=MapConfig(capacity=16, min_features_in_image=8,
                      max_new_per_step=8),
        sim=SimConfig(num_landmarks=24))
    B, T = 8, 4
    scn, xs, obs = sim_scene.simulate(jax.random.key(0), cfg, T)
    st = engine.bootstrap(init_state(cfg),
                          jax.tree.map(lambda a: a[0], obs), cfg)
    st_b = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), st)
    keys = jax.random.split(jax.random.key(1), B)
    mesh = make_mesh()
    final, traj, mean, cov = run_ensemble(st_b, obs, keys, cfg, mesh)
    assert traj.shape == (B, T, CAM_DIM)
    assert mean.shape == (T, CAM_DIM)
    assert cov.shape == (T, 3, 3)
    assert bool(jnp.all(jnp.isfinite(traj)))
    # Ensemble mean equals the plain mean of per-instance trajectories.
    np.testing.assert_allclose(np.asarray(mean),
                               np.asarray(jnp.mean(traj, axis=0)),
                               atol=1e-6)


def test_run_ensemble_8dev_equals_1dev():
    """Cross-device correctness: the SAME ensemble on an 8-device mesh and
    on a single-device mesh must agree (the sharding must be semantically
    invisible) — regression-tests what the driver's dryrun only
    smoke-tests."""
    cfg = EngineConfig(
        map=MapConfig(capacity=16, min_features_in_image=8,
                      max_new_per_step=8),
        sim=SimConfig(num_landmarks=24))
    B, T = 8, 3
    scn, xs, obs = sim_scene.simulate(jax.random.key(2), cfg, T)
    st = engine.bootstrap(init_state(cfg),
                          jax.tree.map(lambda a: a[0], obs), cfg)
    st_b = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), st)
    keys = jax.random.split(jax.random.key(3), B)
    mesh8 = make_mesh()
    mesh1 = make_mesh(data=1)
    f8, t8, m8, c8 = run_ensemble(st_b, obs, keys, cfg, mesh8)
    f1, t1, m1, c1 = run_ensemble(st_b, obs, keys, cfg, mesh1)
    # atol covers sharded-vs-unsharded reduction-order float drift on
    # near-zero elements (observed ~1e-7 on the first-frame positions);
    # semantic equality at trajectory scale (~1e-1) is what matters.
    np.testing.assert_allclose(np.asarray(t8), np.asarray(t1),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(c8), np.asarray(c1),
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(np.asarray(f8.P), np.asarray(f1.P),
                               rtol=1e-5, atol=1e-5)


def test_sharded_train_step_8dev_equals_unsharded():
    """CALC2 data-parallel train step over the 8-device mesh == the plain
    unsharded step (MirroredStrategy-equivalence, utils.py:558-566): same
    loss, same gradients-applied params."""
    from ekf_slam_tpu.data import class_weights, synthetic_batch
    from ekf_slam_tpu.models import train
    from ekf_slam_tpu.models.vss import VSSConfig

    model = train.create_model(VSSConfig(width=8))
    tcfg = train.TrainConfig(batch_size=8, image_hw=(32, 32))
    state0 = train.init_state(model, tcfg, jax.random.key(0))
    imgs, labels = synthetic_batch(jax.random.key(1), 8, (32, 32))
    w = class_weights(labels)
    rng = jax.random.key(2)

    mesh = make_mesh()
    sharded = train.make_sharded_train_step(model, tcfg, mesh)
    s8, m8 = sharded(state0, imgs, labels, w, rng)
    s1, m1 = jax.jit(lambda s, i, l, ww, r: train.train_step(
        model, tcfg, s, i, l, ww, r))(state0, imgs, labels, w, rng)
    np.testing.assert_allclose(float(m8["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    flat8 = jax.tree.leaves(s8.params)
    flat1 = jax.tree.leaves(s1.params)
    for a, b in zip(flat8, flat1):
        # Bound: a zero-vs-epsilon gradient difference between reduction
        # orders moves a param by up to the 1e-3 learning rate in one Adam
        # step (observed 7e-4 worst case); atol sits at 2*lr while rtol
        # still catches structural divergence on normally-updated params.
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=2e-3)


@pytest.mark.slow
def test_sharded_loopdb_equals_single_device():
    """Capacity-sharded loop DB (8 shards): pushes land in the right
    shard slots and the distributed top-k retrieval + verification
    returns the single-device query's result."""
    from ekf_slam_tpu.models import keypoints as kp_mod
    from ekf_slam_tpu.models import loopclosure as lc
    from ekf_slam_tpu.parallel import sharded_loopdb as sdb

    cfg = lc.LoopConfig(capacity=32, top_k=4, exclude_recent=3, min_db=0,
                        sim_threshold=0.5, ransac_hypotheses=16,
                        min_inliers=6)
    NKP, DKP, DD = 16, 6, 12
    rng = np.random.default_rng(0)
    T = 41                                   # > capacity: exercises the wrap
    descrs = rng.normal(size=(T, DD)).astype(np.float32)
    descrs /= np.linalg.norm(descrs, axis=-1, keepdims=True)
    kp_yx = rng.uniform(0, 100, (T, NKP, 2)).astype(np.float32)
    kp_d = rng.normal(size=(T, NKP, DKP)).astype(np.float32)
    poses = rng.normal(size=(T, 7)).astype(np.float32)
    kps = kp_mod.Keypoints(
        yx=jnp.asarray(kp_yx), response=jnp.zeros((T, NKP)),
        orientation=jnp.zeros((T, NKP)), descr=jnp.asarray(kp_d))

    mesh = make_mesh()
    db1 = lc.init_db(cfg, DD, NKP, DKP)
    db8 = sdb.shard_db(lc.init_db(cfg, DD, NKP, DKP), mesh)
    for i in range(T):
        kp_i = jax.tree.map(lambda a: a[i], kps)
        db1 = lc.push(db1, jnp.asarray(descrs[i]), kp_i,
                      jnp.asarray(poses[i]))
        db8 = sdb.push(db8, jnp.asarray(descrs[i]), kp_i,
                       jnp.asarray(poses[i]), mesh)
    for f in ("descr", "kp_yx", "kp_descr", "pose", "frame_id", "count"):
        np.testing.assert_array_equal(np.asarray(getattr(db1, f)),
                                      np.asarray(getattr(db8, f)), f)

    # Query with a descriptor near an old frame's: same retrieval verdict.
    q = jnp.asarray(descrs[7] + 0.01 * rng.normal(size=DD).astype(
        np.float32))
    q = q / jnp.linalg.norm(q)
    kp_q = jax.tree.map(lambda a: a[7], kps)
    r1 = lc.query(db1, q, kp_q, cfg, jax.random.key(5))
    r8 = sdb.query(db8, q, kp_q, cfg, jax.random.key(5), mesh)
    np.testing.assert_allclose(np.asarray(r1.similarities),
                               np.asarray(r8.similarities), rtol=1e-6)
    assert int(r1.best_id) == int(r8.best_id)
    assert int(r1.best_inliers) == int(r8.best_inliers)
    assert bool(r1.is_hypothesis) == bool(r8.is_hypothesis)
    # The matched pose fetch crosses shards correctly.
    np.testing.assert_allclose(
        np.asarray(sdb.best_pose(db8, r8.best_slot, mesh)),
        np.asarray(db1.pose[int(r1.best_slot)]), rtol=1e-6)


@pytest.mark.slow
def test_loop_runner_sharded_db_equals_unsharded():
    """make_frame_fn(mesh=...) — the online loop pipeline on a capacity-
    sharded DB — produces the same fused state and diagnostics as the
    single-device ring."""
    from ekf_slam_tpu.models import loop_runner, loopclosure as lc, train
    from ekf_slam_tpu.models.vss import VSSConfig
    from ekf_slam_tpu.models import keypoints as kp_mod
    from ekf_slam_tpu.parallel import sharded_loopdb as sdb

    model = train.create_model(VSSConfig(width=8))
    tcfg = train.TrainConfig(batch_size=2, image_hw=(32, 32))
    st = train.init_state(model, tcfg, jax.random.key(0))
    variables = {"params": st.params, "batch_stats": st.batch_stats}
    lcfg = lc.LoopConfig(capacity=16, top_k=3, exclude_recent=1, min_db=1,
                         sim_threshold=0.0, ransac_hypotheses=8,
                         min_inliers=1, consistency_count=2)
    imgs = jax.random.uniform(jax.random.key(1), (4, 32, 32, 3))
    x0 = jnp.zeros(13).at[3].set(1.0)
    P0 = jnp.eye(13) * 0.01

    outs = model.apply(variables, imgs[:1], train=False,
                       rngs={"reparam": jax.random.key(2)},
                       descriptor_only=True)
    kps = kp_mod.kp_descriptor(outs["c5"])
    dd, nk, dk = (outs["descriptor"].shape[1], kps.yx.shape[1],
                  kps.descr.shape[2])

    mesh = make_mesh()
    f1 = loop_runner.make_frame_fn(model, variables, lcfg)
    f8 = loop_runner.make_frame_fn(model, variables, lcfg, mesh=mesh)
    db1 = lc.init_db(lcfg, dd, nk, dk)
    db8 = sdb.shard_db(lc.init_db(lcfg, dd, nk, dk), mesh)
    x1, P1, x8, P8 = x0, P0, x0, P0
    for t in range(4):
        k = jax.random.key(10 + t)
        db1, x1, P1, o1 = f1(db1, x1, P1, imgs[t], k)
        db8, x8, P8, o8 = f8(db8, x8, P8, imgs[t], k)
        # allclose treats NaN==NaN as equal — a NaN'd filter state must
        # fail loudly, not match its equally-NaN'd twin.
        assert bool(jnp.isfinite(x1).all() & jnp.isfinite(P1).all()), t
        assert bool(jnp.isfinite(x8).all() & jnp.isfinite(P8).all()), t
        assert bool(o1.declared) == bool(o8.declared), t
        assert int(o1.match_id) == int(o8.match_id), t
        np.testing.assert_allclose(np.asarray(o1.similarity),
                                   np.asarray(o8.similarity), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x8), atol=1e-6)
    np.testing.assert_allclose(np.asarray(P1), np.asarray(P8), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(db1.frame_id),
                                  np.asarray(db8.frame_id))


def test_dp_per_step_body_has_no_collectives():
    """DP-scaling efficiency pin: ensemble instances are
    independent, so the compiled data-parallel per-step program must
    contain NO cross-device collectives — all communication belongs to
    the post-run ensemble statistics (mean/cov), not the SLAM steps.
    Compiled-HLO property via sharded_filter.collective_inventory, the
    same tool that pins the TP filter's no-full-P-collective guarantee
    (reference analog: utils.py:558-566 MirroredStrategy towers)."""
    from ekf_slam_tpu.parallel import replicate
    from ekf_slam_tpu.parallel.sharded_filter import collective_inventory

    cfg = EngineConfig(
        map=MapConfig(capacity=16, min_features_in_image=8,
                      max_new_per_step=8),
        sim=SimConfig(num_landmarks=32))
    scn, xs, obs = sim_scene.simulate(jax.random.key(0), cfg, 3)
    st = engine.bootstrap(
        init_state(cfg), jax.tree.map(lambda a: a[0], obs), cfg)
    B = 8
    st_b = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), st)
    keys = jax.random.split(jax.random.key(1), B)

    mesh = make_mesh()
    st_b = shard_batch(st_b, mesh)
    keys_s = shard_batch(keys, mesh)
    obs_r = replicate(obs, mesh)

    @jax.jit
    def steps_only(states, obs_in, ks):
        return jax.vmap(
            lambda s, k: engine.run_sequence(s, obs_in, k, cfg))(states, ks)

    txt = steps_only.lower(st_b, obs_r, keys_s).compile().as_text()
    colls = collective_inventory(txt)
    assert colls == [], (
        "data-parallel per-step body contains cross-device collectives:\n"
        + "\n".join(colls))
