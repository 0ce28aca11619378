"""1-point RANSAC tests: sampling, support kernel, fixed-batch equivalence.

The reference runs a sequential adaptive loop (ransac_hypotheses.m:14-46,
n = log(1-p)/log(1-eps)); the engine scores a fixed batch of hypotheses
in parallel and takes argmax support. These tests pin (a) the support
projection against a NumPy reference, (b) that sampling only draws IC
slots, and (c) that the fixed batch recovers the inlier set at least as
well as the adaptive loop's operating envelope (inlier ratios where the
reference's own formula terminates within the batch size).
"""

import jax
import jax.numpy as jnp
import numpy as np

from ekf_slam_tpu.config import CAM_DIM, EngineConfig, MapConfig
from ekf_slam_tpu.filter import engine, measurement, ransac
from ekf_slam_tpu.filter.state import init_state
from ekf_slam_tpu.ops import camera as cam_ops
from ekf_slam_tpu.oracle import oracle


def test_sample_ic_indices_only_ic_slots():
    ic = jnp.zeros(20, bool).at[jnp.array([3, 7, 11])].set(True)
    picks = ransac.sample_ic_indices(jax.random.key(0), ic, 64)
    assert set(np.asarray(picks).tolist()) <= {3, 7, 11}
    # roughly uniform across the three
    counts = np.bincount(np.asarray(picks), minlength=20)[[3, 7, 11]]
    assert counts.min() > 5


def test_support_projection_matches_oracle():
    cfg = EngineConfig(map=MapConfig(capacity=6), dtype="float64")
    rng = np.random.default_rng(0)
    st = init_state(cfg)
    x = np.array(st.x, np.float64)  # writable copy
    # 3 cartesian + 3 inverse-depth slots
    for i in range(3):
        x[CAM_DIM + 6 * i: CAM_DIM + 6 * i + 3] = rng.uniform(-1, 1, 3) + \
            np.array([0, 0, 4.0])
    for i in range(3, 6):
        x[CAM_DIM + 6 * i: CAM_DIM + 6 * i + 6] = np.concatenate([
            rng.uniform(-0.1, 0.1, 3), rng.uniform(-0.3, 0.3, 2), [0.5]])
    cartesian = jnp.array([True] * 3 + [False] * 3)
    got = np.asarray(ransac.support_projection(
        jnp.asarray(x), cartesian, cfg))
    R_wc = oracle.q2r(x[3:7])
    for i in range(6):
        y = x[CAM_DIM + 6 * i: CAM_DIM + 6 * i + 6]
        if i < 3:
            hc = np.linalg.inv(R_wc) @ (y[0:3] - x[0:3])
        else:
            hc = np.linalg.inv(R_wc) @ (
                (y[0:3] - x[0:3]) * y[5] + oracle.m_ray(y[3], y[4]))
        uv = oracle.distort(oracle.project(hc, cfg.camera), cfg.camera)
        np.testing.assert_allclose(got[i], uv, atol=1e-9)


def _ransac_setup(outlier_slots, key, cfg):
    """Known map, measurements = truth except gross outliers at given
    slots. Returns everything ransac.run needs."""
    scn_landmarks = np.stack([
        np.linspace(-1, 1, cfg.map.capacity),
        np.linspace(-0.5, 0.5, cfg.map.capacity),
        np.linspace(3, 6, cfg.map.capacity)], axis=1)
    st = init_state(cfg)
    cap = cfg.map.capacity
    slots = jnp.zeros((cap, 6)).at[:, 0:3].set(scn_landmarks)
    x = st.x.at[CAM_DIM:].set(slots.reshape(-1))
    didx = (CAM_DIM + 6 * jnp.arange(cap)[:, None] + jnp.arange(3)).ravel()
    P = st.P.at[didx, didx].set(1e-4)
    P = P.at[jnp.arange(3), jnp.arange(3)].set(1e-4)  # position uncertainty
    st = st.replace(x=x, P=P, active=jnp.ones(cap, bool),
                    cartesian=jnp.ones(cap, bool),
                    landmark_id=jnp.arange(cap))
    h, visible, hc = measurement.predict_measurements(
        x, st.active, st.cartesian, cfg)
    H_xv, H_y = measurement.jacobians(x, h, hc, st.cartesian, cfg.camera)
    S = measurement.innovation_covariances(P, H_xv, H_y, cfg.filter.sigma_z)
    z = h + 0.3 * jax.random.normal(key, h.shape)
    z = z.at[jnp.asarray(outlier_slots)].add(25.0)   # gross outliers
    ic = visible  # pretend everything got matched (IC) incl. outliers
    vm = visible.astype(H_xv.dtype)[:, None, None]
    return st, x, P, z, h, (H_xv * vm, H_y * vm), S, ic


def test_fixed_batch_support_matches_sequential():
    """argmax-support over the fixed hypothesis batch isolates the true
    inlier set: every outlier rejected, (almost) every inlier kept —
    matching what the reference's adaptive loop converges to at these
    inlier ratios (>= 64 draws cover eps >= 7%)."""
    cfg = EngineConfig(map=MapConfig(capacity=24), dtype="float64")
    outliers = [1, 5, 9, 13]
    st, x, P, z, h, (H_xv, H_y), S, ic = _ransac_setup(
        outliers, jax.random.key(1), cfg)
    li, support = ransac.run(x, P, z, h, H_xv, H_y, S, ic, st.cartesian,
                             jax.random.key(2), cfg)
    li = np.asarray(li)
    assert not li[outliers].any(), li
    assert li.sum() >= 15   # most true inliers kept (20 available)
    assert int(support) == li.sum()


def test_ransac_no_ic_matches_is_noop():
    cfg = EngineConfig(map=MapConfig(capacity=8), dtype="float64")
    st, x, P, z, h, (H_xv, H_y), S, _ = _ransac_setup(
        [0], jax.random.key(3), cfg)
    ic = jnp.zeros(8, bool)
    li, support = ransac.run(x, P, z, h, H_xv, H_y, S, ic, st.cartesian,
                             jax.random.key(4), cfg)
    assert not bool(jnp.any(li))
    assert int(support) == 0


def test_gform_apply_matches_pht_form(monkeypatch):
    """EKF_RANSAC_APPLY=gform (x + P·(Hᵀ·A), one natural-layout P read)
    equals the pht form (x + (P·Hᵀ)·A) — identical algebra, so the LI
    mask and support must agree exactly in float64."""
    cfg = EngineConfig(map=MapConfig(capacity=24), dtype="float64")
    outliers = [2, 7, 11]
    st, x, P, z, h, (H_xv, H_y), S, ic = _ransac_setup(
        outliers, jax.random.key(11), cfg)
    results = {}
    for mode in ("pht", "gform"):
        monkeypatch.setattr(ransac, "_APPLY", mode)
        results[mode] = ransac.run(x, P, z, h, H_xv, H_y, S, ic,
                                   st.cartesian, jax.random.key(12), cfg)
    li_p, sup_p = results["pht"]
    li_g, sup_g = results["gform"]
    np.testing.assert_array_equal(np.asarray(li_p), np.asarray(li_g))
    assert int(sup_p) == int(sup_g)
