"""Vision front-end tests: FAST, binary descriptor, NCC, patch warp, and the
full SLAM-from-pixels pipeline on rendered frames."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ekf_slam_tpu.config import (EngineConfig, MapConfig, SimConfig,
                                 VisionConfig)
from ekf_slam_tpu.filter.state import init_state
from ekf_slam_tpu.sim import scene as sim_scene
from ekf_slam_tpu.vision import descriptor, fast, frontend, ncc, patch_warp


def blob_image(h=64, w=64, centers=((20, 30), (40, 12)), sigs=None):
    yy = jnp.arange(h, dtype=jnp.float32)[:, None]
    xx = jnp.arange(w, dtype=jnp.float32)[None, :]
    img = jnp.full((h, w), 0.2, jnp.float32)
    sigs = sigs or [1.5] * len(centers)
    for (cy, cx), sig in zip(centers, sigs):
        img = img + 0.7 * jnp.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                  / (2 * sig * sig))
    return jnp.clip(img, 0.0, 1.0)


def test_fast_detects_blobs():
    img = blob_image()
    score = fast.non_max_suppress(fast.fast_score(img, 0.08, 9))
    yx, vals = fast.top_corners(score, 4)
    found = {tuple(np.asarray(yx[i])) for i in range(2)}
    assert (20, 30) in found and (40, 12) in found
    assert float(vals[0]) > 0


def test_fast_rejects_flat_and_edge():
    img = jnp.full((32, 32), 0.5, jnp.float32)
    img = img.at[:, 16:].set(0.9)      # vertical step edge
    score = fast.fast_score(img, 0.08, 9)
    # Flat regions and straight edges fail the 9-contiguous test.
    assert float(jnp.max(score)) == 0.0


def test_binary_descriptor_matches_same_patch():
    # Distinct local textures -> distinct binary patterns per keypoint.
    # (Radially-symmetric blobs are degenerate for pair-comparison
    # descriptors: sign(I(a)-I(b)) depends only on |a-c| vs |b-c|.)
    key = jax.random.key(7)
    img = jnp.clip(0.5 + 0.3 * jax.random.normal(key, (64, 64)), 0.0, 1.0)
    yx = jnp.array([[20, 30], [40, 12], [50, 50]], jnp.int32)
    d = descriptor.describe(img, yx)
    idx, ok = descriptor.match(d, d, max_distance=10.0)
    np.testing.assert_array_equal(np.asarray(idx), np.arange(3))
    assert bool(jnp.all(ok))
    # Distinct keypoints must be far apart in Hamming distance.
    dist = descriptor.hamming_distance(d, d)
    off_diag = dist + jnp.eye(3) * 1e9
    assert float(jnp.min(off_diag)) > 40.0


def test_ncc_conv_form_matches_patch_gather_reference():
    """The box-filter/grouped-conv fast-NCC (ncc_scores_all) equals the
    naive all-sliding-patches zero-mean NCC it replaced."""
    key = jax.random.key(17)
    C, R, t = 3, 5, 9
    W = t + 2 * R
    wins = jax.random.uniform(key, (C, W, W))
    tmpls = jax.random.uniform(jax.random.key(18), (C, t, t))
    got = np.asarray(ncc.ncc_scores_all(wins, tmpls))
    for c in range(C):
        win, tm = np.asarray(wins[c]), np.asarray(tmpls[c])
        tmz = tm - tm.mean()
        tn = np.sqrt((tmz * tmz).sum() + 1e-12)
        want = np.zeros((2 * R + 1, 2 * R + 1))
        for dv in range(2 * R + 1):
            for du in range(2 * R + 1):
                p = win[dv:dv + t, du:du + t]
                pz = p - p.mean()
                pn = np.sqrt((pz * pz).sum() + 1e-12)
                want[dv, du] = (pz * tmz).sum() / (pn * tn)
        np.testing.assert_allclose(got[c], want, atol=2e-5)


def test_ncc_finds_shifted_template():
    img = blob_image()
    tmpl = img[20 - 6:20 + 7, 30 - 6:30 + 7]    # 13x13 around the blob
    h_pred = jnp.array([27.0, 17.0])            # (u, v) ~3 px off truth
    S = jnp.eye(2) * 25.0
    z, score, found = ncc.match_feature(
        img, tmpl, h_pred, S, chi2_gate=5.9915, search_radius=8,
        min_ncc=0.5)
    assert bool(found)
    np.testing.assert_allclose(np.asarray(z), [30.0, 20.0], atol=0.5)
    assert float(score) > 0.9


def test_ncc_border_window_unbiased():
    """Predictions near the image border: the search window clamps inside
    the image, and the returned z must come from the CLAMPED anchor, not
    from h_pred + offset (advisor finding r1 — the old code returned
    out-of-image z with found=True for a true feature at u=5)."""
    img = blob_image(centers=((20, 5),), sigs=(1.5,))  # feature at u=5,v=20
    tmpl = img[20 - 6:20 + 7, 0:13]  # 13x13 clamped crop around it
    h_pred = jnp.array([5.0, 20.0])  # prediction exactly on the feature
    S = jnp.eye(2) * 100.0           # large S: gate passes wide offsets
    z, score, found = ncc.match_feature(
        img, tmpl, h_pred, S, chi2_gate=5.9915, search_radius=12,
        min_ncc=0.5)
    assert bool(found)
    # In-image and unbiased (within the 0.5 px anchor rounding).
    assert 0.0 <= float(z[0]) and 0.0 <= float(z[1])
    np.testing.assert_allclose(np.asarray(z), [5.0, 20.0], atol=1.0)


def test_ncc_interior_exact_match_centered():
    """Interior feature, prediction on truth: z == truth exactly (no 0.5 px
    anchor bias) and the innovation gate sees true image-frame coords."""
    img = blob_image()
    tmpl = img[20 - 6:20 + 7, 30 - 6:30 + 7]
    z, score, found = ncc.match_feature(
        img, tmpl, jnp.array([30.0, 20.0]), jnp.eye(2) * 25.0,
        chi2_gate=5.9915, search_radius=8, min_ncc=0.5)
    assert bool(found)
    np.testing.assert_allclose(np.asarray(z), [30.0, 20.0], atol=1e-6)


def test_patch_warp_identity_pose():
    """Same pose at init and now -> homography = I -> patch round-trips."""
    cfg = EngineConfig()
    img = blob_image()
    patch = ncc.extract_patch(img, jnp.array([30.0, 20.0]), 20)
    H = patch_warp.plane_homography(
        jnp.zeros(3), jnp.array([1.0, 0, 0, 0]),
        jnp.zeros(3), jnp.array([1.0, 0, 0, 0]),
        jnp.array([0.0, 0.0, 3.0]), cfg.camera)
    np.testing.assert_allclose(np.asarray(H), np.eye(3), atol=1e-5)
    out = patch_warp.warp_patch(
        patch, H, jnp.array([30.0, 20.0]), jnp.array([30.0, 20.0]), 13)
    ref = ncc.extract_patch(img, jnp.array([30.0, 20.0]), 6)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-4)


def _warp_sample_coords(H, center_dst, cam, mode, o=6):
    """Source-pixel sampling coordinates each warp mode uses for the
    (2o+1)^2 dst grid around center_dst."""
    from ekf_slam_tpu.ops import camera as cam_ops
    d = jnp.arange(-o, o + 1, dtype=jnp.float64)
    gy, gx = jnp.meshgrid(d, d, indexing="ij")
    dst = jnp.stack([gx + center_dst[0], gy + center_dst[1]], axis=-1)
    ones = jnp.ones(dst.shape[:-1] + (1,), jnp.float64)
    if mode == "exact":
        du = cam_ops.undistort(dst, cam)
        pts = jnp.concatenate([du, ones], axis=-1).reshape(-1, 3)
        s = pts @ jnp.linalg.inv(H).T
        return cam_ops.distort(s[:, :2] / s[:, 2:3], cam)
    if mode == "affine":
        H = patch_warp.distortion_corrected_homography(H, None, center_dst,
                                                       cam)
    pts = jnp.concatenate([dst, ones], axis=-1).reshape(-1, 3)
    s = pts @ jnp.linalg.inv(H).T
    return s[:, :2] / s[:, 2:3]


def test_warp_distortion_modes_measured():
    """Measures the template-warp distortion approximation against the
    reference-faithful per-pixel round trip (rotate_with_dist_fc_c1c2.m:
    12-17) over a 13-px patch at the default calibration:

      * "affine" (default): < 0.1 px everywhere, including frame corners;
      * "none" (round-1 behavior): sub-px near the center but >5 px
        systematic shift at corners — the documented reason "affine" is
        the default.
    """
    from ekf_slam_tpu.ops import camera as cam_ops
    from ekf_slam_tpu.ops import quaternion as quat
    cfg = EngineConfig()
    cam = cfg.camera
    r1 = jnp.zeros(3, jnp.float64)
    q1 = jnp.array([1.0, 0, 0, 0], jnp.float64)
    r2 = jnp.array([0.15, 0.05, 0.02], jnp.float64)
    q2 = quat.v2q(jnp.array([0.03, 0.08, 0.02], jnp.float64))
    fku = cam.f / cam.d
    corner_devs, center_devs = [], []
    for target in [(20.0, 20.0), (300.0, 220.0), (160.0, 120.0)]:
        uv = jnp.array(target, jnp.float64)
        uvu = cam_ops.undistort(uv, cam)
        ray = jnp.array([(uvu[0] - cam.cx) / fku,
                         (uvu[1] - cam.cy) / fku, 1.0]) * 2.0
        H = patch_warp.plane_homography(r1, q1, r2, q2, ray, cam)
        s_exact = _warp_sample_coords(H, uv, cam, "exact")
        for mode in ("affine", "none"):
            dev = float(jnp.max(jnp.linalg.norm(
                _warp_sample_coords(H, uv, cam, mode) - s_exact, axis=-1)))
            if mode == "affine":
                assert dev < 0.1, (target, dev)
            elif target == (160.0, 120.0):
                center_devs.append(dev)
            else:
                corner_devs.append(dev)
    assert min(corner_devs) > 5.0          # why "none" is no longer default
    assert max(center_devs) < 1.0


def test_predict_appearance_distortion_modes_agree():
    """predict_appearance output: affine mode tracks exact mode closely on
    a textured patch; identity-pose warp still round-trips."""
    cfg = EngineConfig()
    img = blob_image()
    patch41 = ncc.extract_patch(img, jnp.array([30.0, 20.0]), 20)
    patches = patch41[None]
    init_pose = jnp.concatenate([jnp.zeros(3),
                                 jnp.array([1.0, 0, 0, 0])])[None]
    x_cam = jnp.zeros(13).at[3].set(1.0)
    p_w = jnp.array([[0.0, 0.0, 3.0]])
    h = jnp.array([[30.0, 20.0]])
    outs = {m: patch_warp.predict_appearance(
        patches, init_pose, x_cam, p_w, h, h, cfg.camera, 13, distortion=m)
        for m in ("none", "affine", "exact")}
    # Identity pose: every mode reproduces the stored patch center.
    ref = ncc.extract_patch(img, jnp.array([30.0, 20.0]), 6)
    for m, out in outs.items():
        np.testing.assert_allclose(np.asarray(out[0]), np.asarray(ref),
                                   atol=0.05, err_msg=m)
    np.testing.assert_allclose(np.asarray(outs["affine"]),
                               np.asarray(outs["exact"]), atol=0.02)


@pytest.mark.slow
@pytest.mark.parametrize("matcher", ["ncc", "descriptor"])
def test_slam_from_pixels_e2e(matcher):
    """Full image pipeline: render frames -> FAST init -> track -> EKF, in
    BOTH matcher modes: "ncc" (crosscorr.m legacy path) and "descriptor"
    (the reference's primary FAST+FREAK path, matching.m:29-47).
    This is the reference's whole mono_slam loop from pixels (configs[3])."""
    cfg = EngineConfig(
        map=MapConfig(capacity=24, min_features_in_image=10,
                      max_new_per_step=10),
        vision=VisionConfig(search_radius=10, min_ncc=0.4, matcher=matcher,
                            max_hamming=80.0),
        sim=SimConfig(num_landmarks=40, depth_min=2.0, depth_max=6.0,
                      v_init=(0.002, 0.0, 0.004), w_init=(0.0, 0.001, 0.0),
                      traj_accel_std=2e-4, traj_alpha_std=2e-4))
    T = 8
    scn, xs, _ = sim_scene.simulate(jax.random.key(0), cfg, T)
    render = jax.jit(frontend.render_scene_image, static_argnames="cfg")
    st = init_state(cfg)
    app = frontend.init_appearance(cfg)

    step = jax.jit(frontend.step_image, static_argnames="cfg")
    # Bootstrap: run one step on frame 0 (no features yet -> init only).
    n_ic = []
    for t in range(T):
        img = render(scn, xs[t], cfg)
        st, app, info = step(st, app, img, jax.random.key(10 + t), cfg)
        n_ic.append(int(info.n_ic))
    assert int(jnp.sum(st.active)) >= 10
    # After bootstrap the tracker actually matches features from pixels.
    assert n_ic[-1] >= 5, n_ic
    assert bool(jnp.all(jnp.isfinite(st.x)))
    pos_err = float(jnp.linalg.norm(st.x[0:3] - xs[-1][0:3]))
    assert pos_err < 0.1, pos_err


def test_ncc_shift_form_matches_conv():
    """EKF_NCC=shift (fused shift-FMA + integral-image norms) equals the
    grouped-conv NCC to fp noise, including argmax positions."""
    import numpy as np
    from ekf_slam_tpu.vision import ncc
    rng = np.random.default_rng(3)
    win = jnp.asarray(rng.uniform(0, 1, (7, 37, 37)).astype(np.float32))
    tpl = jnp.asarray(rng.uniform(0, 1, (7, 13, 13)).astype(np.float32))
    old = ncc._FORM
    try:
        ncc._FORM = "conv"
        a = np.asarray(ncc.ncc_scores_all(win, tpl))
        ncc._FORM = "shift"
        b = np.asarray(ncc.ncc_scores_all(win, tpl))
        ncc._FORM = "im2col"
        c = np.asarray(ncc.ncc_scores_all(win, tpl))
    finally:
        ncc._FORM = old
    np.testing.assert_allclose(a, b, atol=2e-4)
    np.testing.assert_allclose(a, c, atol=2e-4)
    np.testing.assert_array_equal(a.reshape(7, -1).argmax(-1),
                                  b.reshape(7, -1).argmax(-1))
    np.testing.assert_array_equal(a.reshape(7, -1).argmax(-1),
                                  c.reshape(7, -1).argmax(-1))


def test_ncc_plane_form_matches_conv_match_all():
    """EKF_NCC=plane (full-image im2col matmul + window gathers) produces
    the SAME matches as the windowed grouped-conv form — same candidate
    anchors (incl. border clamping), scores to fp noise, identical picks."""
    import numpy as np
    from ekf_slam_tpu.vision import ncc
    rng = np.random.default_rng(7)
    H, W, C, t, R = 120, 160, 9, 13, 12
    img = jnp.asarray(rng.uniform(0, 1, (H, W)).astype(np.float32))
    tpl = jnp.asarray(rng.uniform(0, 1, (C, t, t)).astype(np.float32))
    # Predictions spread over the interior AND the border-clamp band.
    h_pred = jnp.asarray(np.stack([
        rng.uniform(-5, W + 5, C), rng.uniform(-5, H + 5, C)], -1)
        .astype(np.float32))
    h_pred = h_pred.at[0].set(
        jnp.array([3.0, 2.0], jnp.float32))                 # hard corner
    h_pred = h_pred.at[1].set(jnp.array([W - 2.0, H - 1.0], jnp.float32))
    S = jnp.broadcast_to(jnp.eye(2, dtype=jnp.float32) * 900.0, (C, 2, 2))
    vis = jnp.ones((C,), bool)
    old = ncc._FORM
    try:
        ncc._FORM = "conv"
        za, sa, fa = ncc.match_all(img, tpl, h_pred, S, vis, 5.99, R, 0.5)
        ncc._FORM = "plane"
        zb, sb, fb = ncc.match_all(img, tpl, h_pred, S, vis, 5.99, R, 0.5)
    finally:
        ncc._FORM = old
    np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))
    np.testing.assert_allclose(np.asarray(sa), np.asarray(sb), atol=2e-4)
    np.testing.assert_array_equal(np.asarray(za), np.asarray(zb))


def test_warp_bilinear_dot_matches_gather():
    """EKF_WARP_SAMPLE=dot (one-hot weight contraction) equals the gather
    bilinear to fp noise across random homography warps."""
    import numpy as np
    from ekf_slam_tpu.vision import patch_warp as pw
    rng = np.random.default_rng(11)
    patch = jnp.asarray(rng.uniform(0, 1, (41, 41)).astype(np.float32))
    H = jnp.asarray((np.eye(3) + 0.02 * rng.normal(size=(3, 3)))
                    .astype(np.float32))
    old = pw._SAMPLE
    try:
        pw._SAMPLE = "gather"
        a = np.asarray(pw.warp_patch(patch, H, jnp.array([20.0, 20.0]),
                                     jnp.array([160.0, 120.0]), 13))
        pw._SAMPLE = "dot"
        b = np.asarray(pw.warp_patch(patch, H, jnp.array([20.0, 20.0]),
                                     jnp.array([160.0, 120.0]), 13))
    finally:
        pw._SAMPLE = old
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_describe_many_matches_direct_form():
    """describe_many (patch-slice + selector matmul) is BIT-identical to
    describe_presmoothed (2-D-index gathers) — including centers clipped
    at the image border and coincident A/B pattern points."""
    import numpy as np
    from ekf_slam_tpu.vision import descriptor as ds
    rng = np.random.default_rng(7)
    sm = jnp.asarray(rng.uniform(0, 1, (64, 80)).astype(np.float32))
    yx = jnp.asarray(np.stack([rng.integers(0, 64, 50),
                               rng.integers(0, 80, 50)], -1)
                     .astype(np.int32))
    a = np.asarray(ds.describe_presmoothed(sm, yx))
    b = np.asarray(ds.describe_many(sm, yx))
    np.testing.assert_array_equal(a, b)


def test_fast_arc_forms_equivalent():
    """The AND-doubling arc test (EKF_FASTARC=and) is bit-equivalent to
    thresholding the run-length form at `arc`, for every arc 1..16, on a
    random mask batch including all-True / all-False columns."""
    import numpy as np
    from ekf_slam_tpu.vision import fast
    rng = np.random.default_rng(3)
    mask = jnp.asarray(rng.uniform(size=(16, 64)) < 0.6)
    mask = mask.at[:, 0].set(True).at[:, 1].set(False)
    for arc in range(1, 17):
        a = np.asarray(fast._max_contiguous_run(mask) >= arc)
        b = np.asarray(fast._has_circular_run(mask, arc))
        np.testing.assert_array_equal(a, b, err_msg=f"arc={arc}")


def test_fast_score_form_knob():
    """fast_score produces identical maps under both arc-test forms."""
    import numpy as np
    from ekf_slam_tpu.vision import fast
    rng = np.random.default_rng(4)
    img = jnp.asarray(rng.uniform(0, 1, (48, 64)).astype(np.float32))
    old = fast._ARC_FORM
    try:
        fast._ARC_FORM = "runlen"
        a = np.asarray(fast.fast_score(img, 0.08, 9))
        fast._ARC_FORM = "and"
        b = np.asarray(fast.fast_score(img, 0.08, 9))
    finally:
        fast._ARC_FORM = old
    np.testing.assert_array_equal(a, b)


def test_fast_taps_form_knob():
    """fast_score is identical under roll vs pad+static-slice taps (the
    3-px border is zeroed either way, and interior taps read the same
    in-bounds pixels)."""
    import numpy as np
    from ekf_slam_tpu.vision import fast
    rng = np.random.default_rng(5)
    img = jnp.asarray(rng.uniform(0, 1, (2, 48, 64)).astype(np.float32))
    old = fast._TAPS_FORM
    try:
        fast._TAPS_FORM = "roll"
        a = np.asarray(fast.fast_score(img, 0.08, 9))
        fast._TAPS_FORM = "pad"
        b = np.asarray(fast.fast_score(img, 0.08, 9))
    finally:
        fast._TAPS_FORM = old
    np.testing.assert_array_equal(a, b)


def test_describe_many_flat_form_equivalent():
    """The flat-index gather form of describe_many is bit-identical to the
    slice form (and hence to describe_presmoothed), including clipped
    border centers."""
    import numpy as np
    from ekf_slam_tpu.vision import descriptor as ds
    rng = np.random.default_rng(9)
    sm = jnp.asarray(rng.uniform(0, 1, (64, 80)).astype(np.float32))
    yx = jnp.asarray(np.stack([rng.integers(0, 64, 50),
                               rng.integers(0, 80, 50)], -1)
                     .astype(np.int32))
    a = np.asarray(ds.describe_presmoothed(sm, yx))
    b = np.asarray(ds._describe_many_flat(sm, yx))
    np.testing.assert_array_equal(a, b)


def test_describe_windows_matches_direct_form():
    """describe_windows (per-slot region + one-hot matmul extraction) is
    bit-identical to describe_presmoothed at the equivalent absolute
    candidate positions — including window anchors clipped at every
    border and candidates at window corners."""
    import numpy as np
    from ekf_slam_tpu.vision import descriptor as ds
    rng = np.random.default_rng(11)
    H, W, R, C = 64, 80, 12, 6
    sm = jnp.asarray(rng.uniform(0, 1, (H, W)).astype(np.float32))
    # Centers including all four borders/corners.
    h = np.stack([rng.uniform(-5, W + 5, 40), rng.uniform(-5, H + 5, 40)],
                 -1).astype(np.float32)
    h[:8] = [[0, 0], [W - 1, H - 1], [0, H - 1], [W - 1, 0],
             [W / 2, 0], [0, H / 2], [W / 2, H - 1], [W - 1, H / 2]]
    wy = rng.integers(0, 2 * R + 1, (40, C)).astype(np.int32)
    wx = rng.integers(0, 2 * R + 1, (40, C)).astype(np.int32)
    wy[:, 0] = 0; wx[:, 0] = 0; wy[:, 1] = 2 * R; wx[:, 1] = 2 * R
    got = np.asarray(ds.describe_windows(
        sm, jnp.asarray(h), jnp.asarray(wy), jnp.asarray(wx), R))
    # Reference: absolute positions through describe_presmoothed.
    u0 = np.clip(np.round(h[:, 0]).astype(np.int32) - R, 0, W - (2 * R + 1))
    v0 = np.clip(np.round(h[:, 1]).astype(np.int32) - R, 0, H - (2 * R + 1))
    yy = (v0[:, None] + wy).reshape(-1)
    xx = (u0[:, None] + wx).reshape(-1)
    want = np.asarray(ds.describe_presmoothed(
        sm, jnp.asarray(np.stack([yy, xx], -1)))).reshape(40, C, -1)
    np.testing.assert_array_equal(got, want)


def test_match_descriptor_shared_window_form_equivalent():
    """EKF_MATCHWIN=shared (one padded stacked (2,RG,RG) cut per slot
    serving both the score window and the describe region) returns
    bit-identical (z, dist, found) to the split form — including window
    anchors clamped at every border, where the shared form's pad zeros
    absorb the clamp."""
    import numpy as np
    from ekf_slam_tpu.config import EngineConfig, MapConfig
    from ekf_slam_tpu.vision import descriptor as ds
    from ekf_slam_tpu.vision import frontend as fe
    rng = np.random.default_rng(23)
    H, W, cap = 96, 128, 24
    cfg = EngineConfig(map=MapConfig(capacity=cap), dtype="float32")
    img = jnp.asarray(rng.uniform(0, 1, (H, W)).astype(np.float32))
    d0 = jnp.asarray(np.where(rng.uniform(size=(cap, ds.N_BITS)) > 0.5,
                              1.0, -1.0).astype(np.float32))
    h = np.stack([rng.uniform(-5, W + 5, cap),
                  rng.uniform(-5, H + 5, cap)], -1).astype(np.float32)
    h[:4] = [[0, 0], [W - 1, H - 1], [0, H - 1], [W - 1, 0]]
    S = jnp.asarray(np.broadcast_to(np.eye(2, dtype=np.float32) * 40.0,
                                    (cap, 2, 2))).copy()
    vis = jnp.asarray(rng.uniform(size=cap) > 0.2)
    old_w, old_m = fe._WIN_FORM, ds._MANY_FORM
    try:
        ds._MANY_FORM = "onehot"
        fe._WIN_FORM = "split"
        za, da, fa = fe.match_all_descriptor(img, d0, jnp.asarray(h), S,
                                             vis, cfg)
        fe._WIN_FORM = "shared"
        zb, db, fb = fe.match_all_descriptor(img, d0, jnp.asarray(h), S,
                                             vis, cfg)
    finally:
        fe._WIN_FORM, ds._MANY_FORM = old_w, old_m
    np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))
    np.testing.assert_array_equal(np.asarray(za), np.asarray(zb))
    np.testing.assert_array_equal(np.asarray(da), np.asarray(db))


def test_match_descriptor_chain_window_form_equivalent():
    """EKF_MATCHWIN=chain (the shared-plane cut as two chained
    single-axis dynamic slices — rows at v0, then columns at u0)
    returns bit-identical (z, dist, found) to the one-slice shared
    form, including border-clamped anchors."""
    import numpy as np
    from ekf_slam_tpu.config import EngineConfig, MapConfig
    from ekf_slam_tpu.vision import descriptor as ds
    from ekf_slam_tpu.vision import frontend as fe
    rng = np.random.default_rng(29)
    H, W, cap = 96, 128, 24
    cfg = EngineConfig(map=MapConfig(capacity=cap), dtype="float32")
    img = jnp.asarray(rng.uniform(0, 1, (H, W)).astype(np.float32))
    d0 = jnp.asarray(np.where(rng.uniform(size=(cap, ds.N_BITS)) > 0.5,
                              1.0, -1.0).astype(np.float32))
    h = np.stack([rng.uniform(-5, W + 5, cap),
                  rng.uniform(-5, H + 5, cap)], -1).astype(np.float32)
    h[:4] = [[0, 0], [W - 1, H - 1], [0, H - 1], [W - 1, 0]]
    S = jnp.asarray(np.broadcast_to(np.eye(2, dtype=np.float32) * 40.0,
                                    (cap, 2, 2))).copy()
    vis = jnp.asarray(rng.uniform(size=cap) > 0.2)
    old_w, old_m = fe._WIN_FORM, ds._MANY_FORM
    try:
        ds._MANY_FORM = "onehot"
        fe._WIN_FORM = "shared"
        za, da, fa = fe.match_all_descriptor(img, d0, jnp.asarray(h), S,
                                             vis, cfg)
        fe._WIN_FORM = "chain"
        zb, db, fb = fe.match_all_descriptor(img, d0, jnp.asarray(h), S,
                                             vis, cfg)
    finally:
        fe._WIN_FORM, ds._MANY_FORM = old_w, old_m
    np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))
    np.testing.assert_array_equal(np.asarray(za), np.asarray(zb))
    np.testing.assert_array_equal(np.asarray(da), np.asarray(db))


def test_describe_regions_flat_form_equivalent():
    """EKF_REGEXTRACT=flat (take_along_axis from the compact per-slot
    region stack) is bit-identical to the one-hot matmul contraction form,
    including border-clipped candidates."""
    from ekf_slam_tpu.vision import descriptor as ds
    rng = np.random.default_rng(31)
    H, W, R, C = 64, 80, 12, 8
    sm = jnp.asarray(rng.uniform(0, 1, (H, W)).astype(np.float32))
    h = np.stack([rng.uniform(-5, W + 5, 30),
                  rng.uniform(-5, H + 5, 30)], -1).astype(np.float32)
    h[:4] = [[0, 0], [W - 1, H - 1], [0, H - 1], [W - 1, 0]]
    wy = rng.integers(0, 2 * R + 1, (30, C)).astype(np.int32)
    wx = rng.integers(0, 2 * R + 1, (30, C)).astype(np.int32)
    args = (sm, jnp.asarray(h), jnp.asarray(wy), jnp.asarray(wx), R)
    old = ds._REG_FORM
    try:
        ds._REG_FORM = "onehot"
        a = np.asarray(ds.describe_windows(*args))
        ds._REG_FORM = "flat"
        b = np.asarray(ds.describe_windows(*args))
    finally:
        ds._REG_FORM = old
    np.testing.assert_array_equal(a, b)


@pytest.mark.slow
@pytest.mark.parametrize("matcher,chains", [("ncc", 2), ("descriptor", 2),
                                            ("descriptor", 4)])
def test_staggered_image_driver_bit_equals_step_image(matcher, chains):
    """frontend.run_images_staggered (the software-pipelined k-chain
    driver) reproduces the per-instance step_image scan exactly — same
    math and key schedule, different instruction-level parallelism.

    Bit-equality requires chain size >= 2: a chain of ONE instance
    lowers its batched dots to different (non-batched) kernels with a
    different accumulation order, so floats drift by ~1 ulp while every
    DECISION stays identical — that edge is pinned separately by
    test_staggered_chain_size1_decisions. The bench always runs chain
    sizes >= 2 (bench.py validates BENCH_PIXB % chains == 0 with
    PIXB >= 16*chains defaults)."""
    cfg = EngineConfig(
        map=MapConfig(capacity=24, min_features_in_image=10,
                      max_new_per_step=10),
        vision=VisionConfig(search_radius=10, min_ncc=0.4,
                            matcher=matcher, max_hamming=80.0),
        sim=SimConfig(num_landmarks=40, depth_min=2.0, depth_max=6.0,
                      v_init=(0.002, 0.0, 0.004), w_init=(0.0, 0.001, 0.0),
                      traj_accel_std=2e-4, traj_alpha_std=2e-4))
    B, T = 2 * chains, 5
    scn, xs, _ = sim_scene.simulate(jax.random.key(0), cfg, T)
    render = jax.jit(frontend.render_scene_image, static_argnames="cfg")
    imgs = jnp.stack([render(scn, xs[t], cfg) for t in range(T)])
    st = init_state(cfg)
    app = frontend.init_appearance(cfg)
    st_b = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), st)
    app_b = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), app)
    keys = jax.random.split(jax.random.key(7), B)

    # Reference: the per-instance scan exactly as bench.py main_pixels.
    @jax.jit
    def ref_run(states, apps, ks):
        def one(s, a, k):
            def body(carry, inp):
                s, a = carry
                img, kk = inp
                s, a, info = frontend.step_image(s, a, img, kk, cfg)
                return (s, a), (s.x[:13], info)
            (s, a), (traj, infos) = jax.lax.scan(
                body, (s, a), (imgs, jax.random.split(k, T)))
            return s, a, traj, infos
        return jax.vmap(one)(states, apps, ks)

    ref_st, ref_app, ref_traj, ref_infos = ref_run(st_b, app_b, keys)

    stag = jax.jit(frontend.run_images_staggered,
                   static_argnames=("cfg", "chains"))
    fin, fapp, traj, infos = stag(st_b, app_b, imgs, keys, cfg,
                                  chains=chains)

    np.testing.assert_array_equal(np.asarray(traj), np.asarray(ref_traj))
    np.testing.assert_array_equal(np.asarray(fin.x), np.asarray(ref_st.x))
    np.testing.assert_array_equal(np.asarray(fin.P), np.asarray(ref_st.P))
    np.testing.assert_array_equal(np.asarray(fapp.patches),
                                  np.asarray(ref_app.patches))
    for f in ("n_visible", "n_ic", "n_li", "n_hi", "ransac_support"):
        np.testing.assert_array_equal(
            np.asarray(getattr(infos, f)),
            np.asarray(getattr(ref_infos, f)), err_msg=f)


@pytest.mark.slow
def test_staggered_chain_size1_decisions():
    """Chain size 1 (B == chains): batch-1 chains lower batched dots to
    different kernels (different accumulation order), so floats drift at
    the ~1-ulp level — but every integer DECISION (gates, matches,
    RANSAC support) must be identical and the trajectories must agree to
    float32 rounding."""
    cfg = EngineConfig(
        map=MapConfig(capacity=24, min_features_in_image=10,
                      max_new_per_step=10),
        vision=VisionConfig(search_radius=10, min_ncc=0.4,
                            matcher="descriptor", max_hamming=80.0),
        sim=SimConfig(num_landmarks=40, depth_min=2.0, depth_max=6.0,
                      v_init=(0.002, 0.0, 0.004), w_init=(0.0, 0.001, 0.0),
                      traj_accel_std=2e-4, traj_alpha_std=2e-4))
    B, T = 2, 4
    scn, xs, _ = sim_scene.simulate(jax.random.key(0), cfg, T)
    render = jax.jit(frontend.render_scene_image, static_argnames="cfg")
    imgs = jnp.stack([render(scn, xs[t], cfg) for t in range(T)])
    st = init_state(cfg)
    app = frontend.init_appearance(cfg)
    st_b = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), st)
    app_b = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), app)
    keys = jax.random.split(jax.random.key(7), B)

    @jax.jit
    def ref_run(states, apps, ks):
        def one(s, a, k):
            def body(carry, inp):
                s, a = carry
                img, kk = inp
                s, a, info = frontend.step_image(s, a, img, kk, cfg)
                return (s, a), (s.x[:13], info)
            (s, a), (traj, infos) = jax.lax.scan(
                body, (s, a), (imgs, jax.random.split(k, T)))
            return s, a, traj, infos
        return jax.vmap(one)(states, apps, ks)

    ref_st, ref_app, ref_traj, ref_infos = ref_run(st_b, app_b, keys)
    stag = jax.jit(frontend.run_images_staggered,
                   static_argnames=("cfg", "chains"))
    fin, fapp, traj, infos = stag(st_b, app_b, imgs, keys, cfg, chains=B)

    np.testing.assert_allclose(np.asarray(traj), np.asarray(ref_traj),
                               rtol=0, atol=1e-5)
    for f in ("n_visible", "n_ic", "n_li", "n_hi", "ransac_support"):
        np.testing.assert_array_equal(
            np.asarray(getattr(infos, f)),
            np.asarray(getattr(ref_infos, f)), err_msg=f)
