"""Unit equivalence of the round-2 layout-driven rewrites.

Each rewrite replaced a layout-hostile materialization (small-minor-dim
gather/concat/transpose) with a layout-friendly form. These tests pin the
forms to their naive references directly, in addition to the end-to-end
suites.
"""

import jax
import jax.numpy as jnp
import numpy as np

from ekf_slam_tpu.config import CAM_DIM
from ekf_slam_tpu.filter import measurement
from ekf_slam_tpu.ops import quaternion as quat


def _rand_spd(key, n, dtype=jnp.float64):
    A = jax.random.normal(key, (n, n), dtype)
    return A @ A.T + n * jnp.eye(n, dtype=dtype)


def test_slot_diag_blocks_matches_reshape_indexing():
    cap = 7
    D = CAM_DIM + 6 * cap
    P = _rand_spd(jax.random.key(0), D)
    got = measurement._slot_diag_blocks(P, cap)
    Pm = P[CAM_DIM:, CAM_DIM:].reshape(cap, 6, cap, 6)
    want = Pm[jnp.arange(cap), :, jnp.arange(cap), :]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_pht_slots_flat_ordering():
    """Column 2c+j of the flat pht equals P @ H_cᵀ's j-th column."""
    cap = 5
    D = CAM_DIM + 6 * cap
    key = jax.random.key(1)
    P = _rand_spd(key, D)
    H_xv = jax.random.normal(jax.random.key(2), (cap, 2, CAM_DIM),
                             jnp.float64)
    H_y = jax.random.normal(jax.random.key(3), (cap, 2, 6), jnp.float64)
    flat = measurement.pht_slots(P, H_xv, H_y)
    assert flat.shape == (D, 2 * cap)
    for c in range(cap):
        H = np.zeros((2, D))
        H[:, :CAM_DIM] = np.asarray(H_xv[c])
        H[:, CAM_DIM + 6 * c:CAM_DIM + 6 * c + 6] = np.asarray(H_y[c])
        want = np.asarray(P) @ H.T                       # (D, 2)
        np.testing.assert_allclose(np.asarray(flat[:, 2 * c:2 * c + 2]),
                                   want, rtol=1e-12, atol=1e-12)


def test_stacked_symmetrize_matches_transpose_form():
    """[K|PHt]·[PHt|K]ᵀ == K·PHtᵀ + PHt·Kᵀ, and the downdate stays
    symmetric to machine precision."""
    D, M = 25, 6
    K = jax.random.normal(jax.random.key(4), (D, M), jnp.float64)
    PHt = jax.random.normal(jax.random.key(5), (D, M), jnp.float64)
    A = jnp.concatenate([K, PHt], axis=1)
    B = jnp.concatenate([PHt, K], axis=1)
    got = A @ B.T
    want = K @ PHt.T + PHt @ K.T
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-12, atol=1e-12)
    asym = np.abs(np.asarray(got) - np.asarray(got).T).max()
    assert asym < 1e-12


def test_ransac_pick_matrix_equals_per_pick_gather():
    """The one-hot pick matrix product equals per-pick (D,2) column
    gathers: x + pht2 @ A == x + pht[:, pick] @ w for every hypothesis."""
    cap, nhyp = 6, 9
    D = CAM_DIM + 6 * cap
    pht2 = jax.random.normal(jax.random.key(6), (D, 2 * cap), jnp.float64)
    picks = jax.random.randint(jax.random.key(7), (nhyp,), 0, cap)
    w = jax.random.normal(jax.random.key(8), (nhyp, 2), jnp.float64)
    onehot = jax.nn.one_hot(picks, cap, dtype=jnp.float64)
    A = jnp.einsum("nc,nj->cjn", onehot, w).reshape(2 * cap, nhyp)
    got = pht2 @ A                                       # (D, NHYP)
    for n in range(nhyp):
        col = pht2[:, 2 * picks[n]:2 * picks[n] + 2]
        np.testing.assert_allclose(np.asarray(got[:, n]),
                                   np.asarray(col @ w[n]),
                                   rtol=1e-12, atol=1e-12)


def test_folded_tail_matches_split_update(monkeypatch):
    """EKF_TAIL=folded (renorm transform folded into the rank-(2M+8)
    downdate dot) equals the split stacked-downdate + stripe-renorm
    update exactly (float64)."""
    from ekf_slam_tpu.filter import ekf
    cap = 4
    D = CAM_DIM + 6 * cap
    M = 6
    P = _rand_spd(jax.random.key(20), D)
    H = jax.random.normal(jax.random.key(21), (M, D), jnp.float64) * 0.3
    z = jax.random.normal(jax.random.key(22), (M,), jnp.float64) * 0.05
    h = jnp.zeros((M,), jnp.float64)
    x = jax.random.normal(jax.random.key(23), (D,), jnp.float64)
    x = x.at[3:7].set(x[3:7] / jnp.linalg.norm(x[3:7]) * 1.02)
    mask = jnp.arange(M) < 5
    r = jnp.ones((M,), jnp.float64)

    monkeypatch.setattr(ekf, "_TAIL", "split")
    x_split, P_split = ekf.update(x, P, H, z, h, mask, r)
    monkeypatch.setattr(ekf, "_TAIL", "folded")
    x_fold, P_fold = ekf.update(x, P, H, z, h, mask, r)

    np.testing.assert_allclose(np.asarray(x_fold), np.asarray(x_split),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(P_fold), np.asarray(P_split),
                               rtol=1e-10, atol=1e-10)
    asym = np.abs(np.asarray(P_fold) - np.asarray(P_fold).T).max()
    assert asym < 1e-10


def test_mixed16_split_pht_matches_f32_reference(monkeypatch):
    """EKF_PHT=mixed16 (bf16 split-H single-pass PHt) agrees with the
    f32 dense P·Hᵀ to well below bf16 storage rounding: the two-term
    split Hh + Hl carries ~16 mantissa bits, so the only error of the
    same order as storage rounding is P's own bf16 quantization (shared
    by both sides here)."""
    from ekf_slam_tpu.filter import ekf
    cap = 5
    D = CAM_DIM + 6 * cap
    M = 8
    P32 = _rand_spd(jax.random.key(11), D, jnp.float32)
    Pb = P32.astype(jnp.bfloat16)
    H = jax.random.normal(jax.random.key(12), (M, D), jnp.float32)
    z = jax.random.normal(jax.random.key(13), (M,), jnp.float32) * 0.1
    h = jnp.zeros((M,), jnp.float32)
    x = jax.random.normal(jax.random.key(14), (D,), jnp.float32)
    mask = jnp.ones((M,), bool)
    r = jnp.ones((M,), jnp.float32)

    monkeypatch.setattr(ekf, "_PHT_FORM", "mixed16")
    _, _, pht_mixed = ekf.update_gain(x, Pb, H, z, h, mask, r)
    want = np.asarray(Pb.astype(jnp.float32) @ H.T)
    got = np.asarray(pht_mixed)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 2e-4 * scale


def test_renorm_stripe_form_matches_full_transform():
    """T = I + (normJac − I) stripe adds == T P Tᵀ with the dense T."""
    from ekf_slam_tpu.filter import ekf
    D = CAM_DIM + 12
    P = _rand_spd(jax.random.key(9), D)
    x = jax.random.normal(jax.random.key(10), (D,), jnp.float64)
    x_new, P_new = ekf._renormalize_quaternion(x, P)
    J = quat.norm_jac(x[3:7])
    T = jnp.eye(D, dtype=P.dtype).at[3:7, 3:7].set(J)
    want = T @ P @ T.T
    np.testing.assert_allclose(np.asarray(P_new), np.asarray(want),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(x_new[3:7]),
        np.asarray(x[3:7] / jnp.linalg.norm(x[3:7])), rtol=1e-12)


def _rand_blocks(cap, kxv=40, ky=41):
    H_xv = jax.random.normal(jax.random.key(kxv), (cap, 2, CAM_DIM),
                             jnp.float64)
    H_y = jax.random.normal(jax.random.key(ky), (cap, 2, 6), jnp.float64)
    return H_xv, H_y


def test_pht_rows_split_matches_pht_slots():
    """Row c of hp_u/hp_v equals column 2c/2c+1 of the column-form
    pht_slots (P symmetric ⇒ H·P rows = (P·Hᵀ)ᵀ columns)."""
    cap = 6
    D = CAM_DIM + 6 * cap
    P = _rand_spd(jax.random.key(39), D)
    H_xv, H_y = _rand_blocks(cap)
    hp_u, hp_v = measurement.pht_rows_split(P, H_xv, H_y)
    flat = measurement.pht_slots(P, H_xv, H_y)            # (D, 2·CAP)
    np.testing.assert_allclose(np.asarray(hp_u),
                               np.asarray(flat[:, 0::2].T),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(hp_v),
                               np.asarray(flat[:, 1::2].T),
                               rtol=1e-12, atol=1e-12)


def test_innovation_covariances_from_hp_matches_direct():
    """S_c from the split hp rows equals H_c·P·H_cᵀ + σ²I computed with
    the dense per-slot H."""
    cap = 5
    D = CAM_DIM + 6 * cap
    sigma = 1.3
    P = _rand_spd(jax.random.key(42), D)
    H_xv, H_y = _rand_blocks(cap, 43, 44)
    hp_u, hp_v = measurement.pht_rows_split(P, H_xv, H_y)
    S = measurement.innovation_covariances_from_hp(
        hp_u, hp_v, H_xv, H_y, sigma)
    for c in range(cap):
        H = np.zeros((2, D))
        H[:, :CAM_DIM] = np.asarray(H_xv[c])
        H[:, CAM_DIM + 6 * c:CAM_DIM + 6 * c + 6] = np.asarray(H_y[c])
        want = H @ np.asarray(P) @ H.T + sigma ** 2 * np.eye(2)
        np.testing.assert_allclose(np.asarray(S[c]), want,
                                   rtol=1e-11, atol=1e-11)


def test_compact_dense_H_block_rows():
    """Block-order compact H: row m is slot sel[m]'s u row, row M+m its
    v row, masked rows zero."""
    cap, M = 7, 4
    H_xv, H_y = _rand_blocks(cap, 45, 46)
    slots = jnp.array([3, 0, 6, 2])
    mask = jnp.array([True, True, False, True])
    Hc = measurement.compact_dense_H_block(
        H_xv[slots], H_y[slots], slots, mask, cap)
    D = CAM_DIM + 6 * cap
    assert Hc.shape == (2 * M, D)
    for m in range(M):
        c = int(slots[m])
        for comp in range(2):
            want = np.zeros(D)
            if bool(mask[m]):
                want[:CAM_DIM] = np.asarray(H_xv[c, comp])
                want[CAM_DIM + 6 * c:CAM_DIM + 6 * c + 6] = \
                    np.asarray(H_y[c, comp])
            np.testing.assert_allclose(
                np.asarray(Hc[comp * M + m]), want, atol=1e-12)


def test_update_rows_matches_update():
    """ekf.update_rows (row-form operands, K never materialized) equals
    ekf.update on the same measurement set in float64 — including the
    folded quaternion-renorm tail and masked rows."""
    from ekf_slam_tpu.filter import ekf
    cap = 4
    D = CAM_DIM + 6 * cap
    M = 6
    P = _rand_spd(jax.random.key(50), D)
    H = jax.random.normal(jax.random.key(51), (M, D), jnp.float64) * 0.3
    z = jax.random.normal(jax.random.key(52), (M,), jnp.float64) * 0.05
    h = jnp.zeros((M,), jnp.float64)
    x = jax.random.normal(jax.random.key(53), (D,), jnp.float64)
    x = x.at[3:7].set(x[3:7] / jnp.linalg.norm(x[3:7]) * 1.02)
    mask = jnp.arange(M) < 5
    r = jnp.ones((M,), jnp.float64)

    x_ref, P_ref = ekf.update(x, P, H, z, h, mask, r)
    HP = (H * mask[:, None].astype(H.dtype)) @ P
    x_row, P_row = ekf.update_rows(x, P, H, HP, z, h, mask, r)

    np.testing.assert_allclose(np.asarray(x_row), np.asarray(x_ref),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(P_row), np.asarray(P_ref),
                               rtol=1e-10, atol=1e-10)
    asym = np.abs(np.asarray(P_row) - np.asarray(P_row).T).max()
    assert asym < 1e-10


def test_ransac_hp_apply_matches_pht_apply():
    """RANSAC hypothesis apply from split hp rows equals the column-form
    pht2 @ A product for the same picks."""
    cap, nhyp = 6, 8
    D = CAM_DIM + 6 * cap
    P = _rand_spd(jax.random.key(60), D)
    H_xv, H_y = _rand_blocks(cap, 61, 62)
    hp_u, hp_v = measurement.pht_rows_split(P, H_xv, H_y)
    pht2 = measurement.pht_slots(P, H_xv, H_y)            # (D, 2·CAP)
    picks = jax.random.randint(jax.random.key(63), (nhyp,), 0, cap)
    w = jax.random.normal(jax.random.key(64), (nhyp, 2), jnp.float64)
    onehot = jax.nn.one_hot(picks, cap, dtype=jnp.float64)
    A = jnp.einsum("nc,nj->cjn", onehot, w).reshape(2 * cap, nhyp)
    want = pht2 @ A
    A3 = A.reshape(cap, 2, nhyp)
    got = hp_u.T @ A3[:, 0, :] + hp_v.T @ A3[:, 1, :]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-11, atol=1e-11)


def test_ransac_soa_support_matches_vmap_projection():
    """EKF_RANSAC=soa (all-hypothesis (CAP,N) component form) equals the
    per-hypothesis support_projection residuals (float64)."""
    from ekf_slam_tpu.config import EngineConfig, MapConfig
    from ekf_slam_tpu.filter import ransac

    cap, nhyp = 9, 5
    cfg = EngineConfig(map=MapConfig(capacity=cap))
    D = CAM_DIM + 6 * cap
    key = jax.random.key(30)
    x_hyps = jax.random.normal(key, (D, nhyp), jnp.float64)
    # unit quaternions per hypothesis, plausible geometry
    q = x_hyps[3:7]
    x_hyps = x_hyps.at[3:7].set(q / jnp.linalg.norm(q, axis=0))
    # keep slot points in front of the camera-ish
    x_hyps = x_hyps.at[CAM_DIM + 2::6].add(8.0)
    x_hyps = x_hyps.at[CAM_DIM + 5::6].set(
        jnp.abs(x_hyps[CAM_DIM + 5::6]) + 0.2)
    z = jax.random.uniform(jax.random.key(31), (cap, 2), jnp.float64,
                           20.0, 300.0)
    cartesian = jnp.arange(cap) % 2 == 0

    res2_soa = ransac.support_residuals_soa(x_hyps, z, cartesian, cfg)

    def one(x_hyp):
        h_all = ransac.support_projection(x_hyp, cartesian, cfg)
        return jnp.sum((z - h_all) ** 2, axis=-1)

    res2_ref = jax.vmap(one, in_axes=1, out_axes=1)(x_hyps)
    np.testing.assert_allclose(np.asarray(res2_soa), np.asarray(res2_ref),
                               rtol=1e-9, atol=1e-9)


def test_innovation_covariances_soa_matches_aos(monkeypatch):
    """EKF_S1FORM=soa (split-component 2-D assembly) equals the
    (CAP, 2, k) einsum form to fp-reduction order — float64."""
    from ekf_slam_tpu.filter import measurement as m
    rng = np.random.default_rng(5)
    cap, D = 9, CAM_DIM + 9 * 6
    A = rng.normal(size=(D, D))
    P = jnp.asarray(A @ A.T)
    H_xv = jnp.asarray(rng.normal(size=(cap, 2, CAM_DIM)))
    H_y = jnp.asarray(rng.normal(size=(cap, 2, 6)))
    monkeypatch.setattr(m, "_S1FORM", "aos")
    S_aos = m.innovation_covariances(P, H_xv, H_y, 1.3)
    monkeypatch.setattr(m, "_S1FORM", "soa")
    S_soa = m.innovation_covariances(P, H_xv, H_y, 1.3)
    np.testing.assert_allclose(np.asarray(S_soa), np.asarray(S_aos),
                               rtol=1e-11, atol=1e-11)
    # the SoA form is exactly symmetric by construction
    np.testing.assert_array_equal(np.asarray(S_soa),
                                  np.asarray(jnp.swapaxes(S_soa, -1, -2)))


def test_slot_diag_blocks_forms_equal(monkeypatch):
    """All EKF_SDIAG extraction forms (flatgather / blockreduce / reduce)
    return bit-identical slot diagonal blocks."""
    from ekf_slam_tpu.filter import measurement as m
    cap = 5
    D = CAM_DIM + 6 * cap
    P = jnp.asarray(np.random.default_rng(0).normal(size=(D, D)))
    outs = {}
    for form in ("flatgather", "blockreduce", "reduce", "dotsel"):
        monkeypatch.setattr(m, "_SDIAG", form)
        outs[form] = np.asarray(m._slot_diag_blocks(P, cap))
    np.testing.assert_array_equal(outs["flatgather"], outs["blockreduce"])
    np.testing.assert_array_equal(outs["flatgather"], outs["reduce"])
    np.testing.assert_array_equal(outs["flatgather"], outs["dotsel"])


def test_predict_stripe_forms_bit_identical():
    """EKF_STRIPES pred / predT / predsel write the same P_pred bitwise
    (predT reorders the two stripe writes through offset (0,0); predsel
    replaces them with mask-selects — the tensor-parallel forms,
    parallel/sharded_filter.py)."""
    from ekf_slam_tpu.config import FilterConfig
    from ekf_slam_tpu.filter import ekf
    cap = 5
    D = CAM_DIM + 6 * cap
    rng = np.random.default_rng(1)
    P = jnp.asarray(_rand_spd(jax.random.key(1), D, jnp.float32))
    x = jnp.asarray(rng.normal(size=(D,)).astype(np.float32))
    x = x.at[3:7].set(x[3:7] / jnp.linalg.norm(x[3:7]))
    cfg = FilterConfig()
    outs = {}
    for form in ("pred", "predT", "predsel"):
        with ekf.stripes_override(form):
            x2, P2 = ekf.predict(x, P, cfg)
        outs[form] = (np.asarray(x2), np.asarray(P2))
    for form in ("predT", "predsel"):
        np.testing.assert_array_equal(outs["pred"][0], outs[form][0])
        np.testing.assert_array_equal(outs["pred"][1], outs[form][1])


def test_manage_rowsel_form_bit_identical():
    """EKF_MGROWS slotdot / rowsel conversion row extraction produce the
    same managed state (both are exact one-hot selections)."""
    from ekf_slam_tpu.config import EngineConfig, MapConfig, SimConfig
    from ekf_slam_tpu.filter import engine, mapman
    from ekf_slam_tpu.filter.state import init_state
    from ekf_slam_tpu.sim import scene as sim_scene
    cfg = EngineConfig(
        map=MapConfig(capacity=8, min_features_in_image=5,
                      max_new_per_step=5,
                      linearity_threshold=10.0),    # force conversions
        sim=SimConfig(num_landmarks=12), dtype="float32")
    scn, xs, obs = sim_scene.simulate(jax.random.key(2), cfg, 3)
    st = engine.bootstrap(init_state(cfg),
                          jax.tree.map(lambda a: a[0], obs), cfg)
    # a couple of frames so P has cross terms and conversions trigger
    for t in (1, 2):
        st, _ = engine.step(st, jax.tree.map(lambda a: a[t], obs),
                            jax.random.key(3 + t), cfg)
    outs = {}
    for form in ("slotdot", "rowsel"):
        with mapman.mgrows_override(form):
            outs[form] = mapman.manage(st, cfg)
    assert bool(jnp.any(outs["slotdot"].cartesian)), \
        "setup must actually convert a feature"
    np.testing.assert_array_equal(np.asarray(outs["slotdot"].x),
                                  np.asarray(outs["rowsel"].x))
    np.testing.assert_array_equal(np.asarray(outs["slotdot"].P),
                                  np.asarray(outs["rowsel"].P))
    np.testing.assert_array_equal(np.asarray(outs["slotdot"].cartesian),
                                  np.asarray(outs["rowsel"].cartesian))


def test_jacobian_chain_forms_bit_identical(monkeypatch):
    """EKF_JACFORM chain3 / fused produce bit-identical H_xv, H_y (same
    3-term dots, one concatenated contraction vs three)."""
    from ekf_slam_tpu.config import CameraConfig
    from ekf_slam_tpu.filter import measurement as m
    cap = 7
    D = CAM_DIM + 6 * cap
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(D,)).astype(np.float32))
    x = x.at[3:7].set(x[3:7] / jnp.linalg.norm(x[3:7]))
    cartesian = jnp.asarray([True, False, True, False, False, True, False])
    cam = CameraConfig()
    slots = x[CAM_DIM:].reshape(cap, 6)
    hc = m.camera_frame_points(x, slots, cartesian)
    hc = jnp.where(hc[:, 2:3] > 0.1, hc, jnp.array([0.0, 0.0, 1.0]))
    from ekf_slam_tpu.ops import camera as cam_ops
    h = cam_ops.distort(cam_ops.project(hc, cam), cam)
    outs = {}
    for form in ("chain3", "fused"):
        monkeypatch.setattr(m, "_JACFORM", form)
        outs[form] = m.jacobians(x, h, hc, cartesian, cam)
    np.testing.assert_array_equal(np.asarray(outs["chain3"][0]),
                                  np.asarray(outs["fused"][0]))
    np.testing.assert_array_equal(np.asarray(outs["chain3"][1]),
                                  np.asarray(outs["fused"][1]))


def test_rhovar_rows_form_bit_equals_gather(monkeypatch):
    """Conversion rho-variance extraction: the natural-layout strided-
    rows + constant-mask form (EKF_RHOVAR=rows) must reproduce the
    2-D-index diagonal gather bit-exactly (both are exact selections of
    the same P elements), with and without an eligible conversion."""
    from ekf_slam_tpu.config import EngineConfig, MapConfig
    from ekf_slam_tpu.filter import mapman
    from ekf_slam_tpu.filter.state import init_state

    for thresh, key in ((1e9, 0), (1e-12, 1)):   # always / never eligible
        cfg = EngineConfig(map=MapConfig(capacity=8,
                                         linearity_threshold=thresh),
                           dtype="float64")
        st = init_state(cfg)
        uvd = jax.random.uniform(jax.random.key(key), (5, 2),
                                 minval=60.0, maxval=180.0,
                                 dtype=jnp.float64)
        st, _ = mapman.add_features_batch(
            st, uvd, jnp.ones(5, bool), jnp.arange(5, dtype=jnp.int32),
            cfg)
        # de-trivialize P so the extracted variances differ per slot
        D = st.P.shape[0]
        bump = 0.1 * jax.random.uniform(jax.random.key(7), (D,),
                                        dtype=jnp.float64)
        st = st.replace(P=st.P + jnp.diag(bump))

        monkeypatch.setattr(mapman, "_RHOVAR", "gather")
        ref = mapman.convert_to_cartesian(st, cfg)
        monkeypatch.setattr(mapman, "_RHOVAR", "rows")
        out = mapman.convert_to_cartesian(st, cfg)
        # the permissive threshold must actually exercise a conversion
        assert bool(jnp.any(ref.cartesian)) == (thresh > 1.0)

        np.testing.assert_array_equal(np.asarray(ref.x), np.asarray(out.x))
        np.testing.assert_array_equal(np.asarray(ref.P), np.asarray(out.P))
        np.testing.assert_array_equal(np.asarray(ref.cartesian),
                                      np.asarray(out.cartesian))
