"""Image front-end: full SLAM-from-pixels pipeline (BASELINE.json configs[3]).

Replaces the reference's CV-toolbox matcher (matching.m) and the
ROI-box feature initializer (initialize_a_feature.m:22-54) with batched
fixed-shape equivalents, and provides a renderer so the image pipeline is
testable without the missing sequence (mono_slam.m:21, SURVEY.md §2.9):

* `render_scene_image` — synthesizes a grayscale frame from the landmark
  field: isotropic Gaussian intensity bumps (separable => two small
  matmuls), which FAST's contiguous-arc test detects and NCC can lock onto.
* `Appearance` — per-slot stored 41x41 init patch + init pose + init pixel
  (the patch_when_initialized / r_wc / uv_when_initialized fields of
  add_feature_to_info_vector.m:7-32).
* `measure` — predicted appearance via plane homography (pred_patch_fc) +
  NCC search in the chi^2-gated window (matching.m) -> (z, z_valid).
* `select_new_feature_pixels` — FAST corners away from current predictions
  and the image border. The reference samples random 60x40 ROI boxes until
  one is empty of predictions (initialize_a_feature.m:22-48, a host-loop
  idiom); taking global top-K corners OUTSIDE exclusion disks implements the
  same "spread new features away from tracked ones" policy branchlessly.
* `step_image` — the whole frame: match -> step_core -> initialize.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ekf_slam_tpu.config import CAM_DIM, EngineConfig
from ekf_slam_tpu.filter import ekf, engine, mapman, measurement
from ekf_slam_tpu.filter.association import mahalanobis2
from ekf_slam_tpu.filter.state import FilterState
from ekf_slam_tpu.ops import quaternion as quat
from ekf_slam_tpu.sim.scene import Scene
from ekf_slam_tpu.utils import pytree
from ekf_slam_tpu.vision import descriptor, fast, ncc, patch_warp

INIT_PATCH_HALF = 20   # 41x41 init patch (initialize_a_feature.m:4)
MATCH_PATCH_HALF = 6   # 13x13 matching patch (initialize_a_feature.m:5)
BORDER = 21            # image border exclusion (initialize_a_feature.m:22)

# Descriptor-matcher window-extraction form (EKF_MATCHWIN): "shared" =
# ONE (2, 2R+15, 2R+15) slice per slot from a zero-padded stacked
# [score; smooth] plane — the score window is its static interior, the
# describe region rides along free (the "split" form makes two dynamic
# extractions per slot). "chain" = the same shared-plane cut as TWO
# chained single-axis dynamic slices (rows at v0, then columns at u0):
# under the slot vmap a slice with two batched minor-dim offsets lowers
# as a 2-D gather, while chained single-axis slices lower as 1-D
# gathers. Which is fastest on the GPU is not measured yet (ROADMAP S6).
# Output-pinned bit-identical
# (tests/test_vision.py).
import os as _os
_WIN_FORM = _os.environ.get("EKF_MATCHWIN", "shared")


@pytree.dataclass
class Appearance:
    patches: jnp.ndarray    # (CAP, 41, 41) init patches
    init_pose: jnp.ndarray  # (CAP, 7) [r(3) q(4)] camera pose at init
    init_px: jnp.ndarray    # (CAP, 2) pixel at init
    descr: jnp.ndarray      # (CAP, N_BITS) ±1 init binary descriptor
                            # (the FREAK slot of add_feature_to_info_vector)


def init_appearance(cfg: EngineConfig) -> Appearance:
    cap = cfg.map.capacity
    p = 2 * INIT_PATCH_HALF + 1
    dt = cfg.jnp_dtype
    return Appearance(
        patches=jnp.zeros((cap, p, p), dt),
        init_pose=jnp.zeros((cap, 7), dt).at[:, 3].set(1.0),
        init_px=jnp.zeros((cap, 2), dt),
        descr=jnp.zeros((cap, descriptor.N_BITS), dt))


def render_scene_image(scene: Scene, x_cam: jnp.ndarray,
                       cfg: EngineConfig) -> jnp.ndarray:
    """Grayscale (n_rows, n_cols) frame: Gaussian bumps at the projected
    landmarks over a mid-gray background. Separable kernels keep it to two
    (H, L) x (L, W) matmuls."""
    from ekf_slam_tpu.ops import camera as cam_ops
    cam = cfg.camera
    L = scene.landmarks.shape[0]
    t_wc, q_wc = x_cam[0:3], x_cam[3:7]
    R_wc = quat.q2r(q_wc)
    hc = (scene.landmarks - t_wc) @ R_wc
    ok = hc[:, 2] > 1e-3
    hc_safe = jnp.where(ok[:, None], hc, jnp.array([0.0, 0.0, 1.0],
                                                   x_cam.dtype))
    px = cam_ops.distort(cam_ops.project(hc_safe, cam), cam)
    # Per-landmark deterministic amplitude/width (stable across frames).
    ids = jnp.arange(L)
    # int32-safe multiplicative hashes (stay below 2^31 for L <= a few 1e4)
    amp = 0.35 + 0.45 * ((ids * 69069 % 97) / 96.0)
    sig = 1.2 + 1.3 * ((ids * 40503 % 89) / 88.0)
    amp = jnp.where(ok, amp, 0.0)
    yy = jnp.arange(cam.n_rows, dtype=x_cam.dtype)
    xx = jnp.arange(cam.n_cols, dtype=x_cam.dtype)
    gy = jnp.exp(-0.5 * ((yy[:, None] - px[None, :, 1]) / sig) ** 2)  # (H,L)
    gx = jnp.exp(-0.5 * ((xx[:, None] - px[None, :, 0]) / sig) ** 2)  # (W,L)
    img = 0.2 + gy @ (amp[:, None] * gx.T)
    return jnp.clip(img, 0.0, 1.0)


def landmark_world_points(state: FilterState) -> jnp.ndarray:
    """Current 3D point estimate per slot: y + m(θ,φ)/ρ for inverse-depth
    (inversedepth2cartesian.m:1-12), y for cartesian."""
    slots = state.slot_values()
    y3 = slots[:, 0:3]
    rho = slots[:, 5]
    safe_rho = jnp.where(rho == 0, jnp.ones_like(rho), rho)
    mi = quat.azel_to_ray(slots[:, 3], slots[:, 4])
    p_id = y3 + mi / safe_rho[:, None]
    return jnp.where(state.cartesian[:, None], y3, p_id)


def measure(state: FilterState, app: Appearance, img: jnp.ndarray,
            cfg: EngineConfig):
    """Predict + match from a freshly-computed prior (standalone use; the
    per-frame pipeline uses measure_at_prior so ekf.predict runs ONCE)."""
    x_prior, P_prior = ekf.predict(state.x, state.P, cfg.filter)
    return measure_at_prior(state, app, img, x_prior, P_prior, cfg)[:4]


def measure_at_prior(state: FilterState, app: Appearance, img: jnp.ndarray,
                     x_prior: jnp.ndarray, P_prior: jnp.ndarray,
                     cfg: EngineConfig):
    """Appearance matching at a given prior ->
    (z, z_valid, h, visible, r_needed).

    `r_needed` () is the exact search radius the χ² gate can reach this
    frame: max over MATCHABLE slots of sqrt(chi2 · λmax(S)) — the gated
    argmax in the (2R+1)² window is BIT-EXACT to an unbounded search iff
    search_radius ≥ r_needed (offsets beyond the ellipse are masked to
    -inf). The static radius is sized to the measured workload max the
    same way the compact update's M is, with this value
    surfaced through StepInfo as the in-run honesty gate.

    Matcher selected by cfg.vision.matcher:
    * "ncc"        — plane-homography-warped template + NCC scan over the
                     χ²-gated window (crosscorr.m legacy path).
    * "descriptor" — FAST corners inside the window, χ² gate on the corner
                     innovation, binary-descriptor Hamming match against
                     the stored init descriptor — the reference's primary
                     matcher (matching.m:29-47: detectFASTFeatures in the
                     ±2σ box, chi-square gating, FREAK matchFeatures).
    """
    f = cfg.filter
    h, visible, hc = measurement.predict_measurements(
        x_prior, state.active, state.cartesian, cfg)
    H_xv, H_y = measurement.jacobians(x_prior, h, hc, state.cartesian,
                                      cfg.camera)
    S = measurement.innovation_covariances(P_prior, H_xv, H_y, f.sigma_z)
    # The reference gates matching itself on eig(S) < 100 (matching.m:16)
    # — a wildly-uncertain (fresh inverse-depth) feature is not searched
    # at all. Downstream association.individually_compatible re-applies
    # the same gate, so pre-gating here is behavior-neutral; it also
    # bounds the χ²-reach diagnostic to sqrt(chi2 · max_eig) so the
    # static window can be sized against the MATCHABLE workload.
    tr = S[..., 0, 0] + S[..., 1, 1]                     # closed-form λmax
    det = S[..., 0, 0] * S[..., 1, 1] - S[..., 0, 1] * S[..., 1, 0]
    lmax = tr / 2 + jnp.sqrt(jnp.maximum(tr * tr / 4 - det, 0.0))
    matchable = visible & (lmax < cfg.matching.max_innovation_eig)
    r_needed = jnp.max(jnp.where(
        matchable, jnp.sqrt(cfg.matching.chi2_inv_2_95 * lmax), 0.0))
    # Attribution knobs (EKF_ABLATE, non-benchmark runs only): "match"
    # skips the whole appearance matcher (warp + scoring), "ncc" keeps
    # the template warp but skips the correlation scan — the difference
    # isolates the NCC scoring cost on the real bench.
    if "match" in engine._ABLATE and cfg.vision.matcher != "descriptor":
        return h, visible, h, visible, r_needed
    if cfg.vision.matcher == "descriptor":
        if "dmatch" in engine._ABLATE:
            return h, visible, h, visible, r_needed
        z, score, found = match_all_descriptor(
            img, app.descr, h, S, matchable, cfg)
    else:
        p_w = landmark_world_points(state)
        templates = patch_warp.predict_appearance(
            app.patches, app.init_pose, x_prior[:CAM_DIM], p_w,
            app.init_px, h, cfg.camera, out_size=2 * MATCH_PATCH_HALF + 1,
            distortion=cfg.vision.warp_distortion)
        if "ncc" in engine._ABLATE:
            return jnp.sum(templates, (-2, -1))[:, None] * 0 + h, \
                visible, h, visible, r_needed
        z, score, found = ncc.match_all(
            img, templates, h, S, matchable,
            cfg.matching.chi2_inv_2_95, cfg.vision.search_radius,
            cfg.vision.min_ncc)
    return z, found, h, visible, r_needed


def match_all_descriptor(img: jnp.ndarray, descr_init: jnp.ndarray,
                         h_pred: jnp.ndarray, S: jnp.ndarray,
                         visible: jnp.ndarray, cfg: EngineConfig):
    """FAST + binary-descriptor matching per predicted feature
    (matching.m:29-47 as batched fixed-shape ops).

    Per slot: crop the (2R+1)² window of the frame's NMS'd FAST response
    around h_pred, keep the top `corners_per_window` corners, χ²-gate their
    innovations against S (matching.m:38), describe them and pick the
    minimum-Hamming candidate under max_hamming (matchFeatures with
    MaxRatio 1 + threshold, matching.m:45-47). Returns (z, dist, found).
    """
    v = cfg.vision
    R = v.search_radius
    C = v.corners_per_window
    chi2 = cfg.matching.chi2_inv_2_95
    # Attribution knobs (EKF_ABLATE, non-benchmark runs only): "fast"
    # replaces the corner response with the raw image (isolates the FAST
    # score + NMS cost), "describe" skips the descriptor computation
    # (isolates describe_many + the Hamming pick).
    if "fast" in engine._ABLATE:
        score = img
    else:
        score = fast.non_max_suppress(
            fast.fast_score(img, v.fast_threshold, v.fast_arc))
    sm = descriptor._smooth3(img)            # smooth once per frame
    W2 = 2 * R + 1
    H, W = img.shape

    def pick(d0, dc, gate_i, cu_i, cv_i):
        dist = 0.5 * (dc.shape[-1] - dc @ d0)                # Hamming
        dist = jnp.where(gate_i, dist, jnp.inf)
        best = jnp.argmin(dist)
        found = jnp.isfinite(dist[best]) & (dist[best] <= v.max_hamming)
        z = jnp.stack([cu_i[best], cv_i[best]])
        return z, jnp.where(jnp.isfinite(dist[best]), dist[best], 1e9), found

    shared = (_WIN_FORM in ("shared", "chain")
              and descriptor._MANY_FORM == "onehot"
              and not ({"winext", "topk"} & engine._ABLATE))
    if shared:
        # ONE per-slot dynamic extraction instead of two: cut a
        # (2, RG, RG) block from the zero-padded stacked [score; smooth]
        # plane at the window anchor. In padded coordinates the score
        # window is ALWAYS the static interior [r:r+W2, r:r+W2] of the
        # block (the pad absorbs the border clamp), and the smooth
        # region hands straight to descriptor.describe_regions with
        # anchor (u0-r, v0-r) — candidate patches are clipped inside
        # the true image, so pad zeros are never selected and the
        # output is bit-identical to the split form (pinned).
        r = descriptor.PATCH // 2
        RG = W2 + 2 * r
        plane = jnp.zeros((2, H + 2 * r, W + 2 * r), img.dtype)
        plane = plane.at[:, r:H + r, r:W + r].set(jnp.stack([score, sm]))

        def cands_shared(h, Si):
            # Attribution knob (EKF_ABLATE): "sharedext" pins the block
            # cut to a constant offset (XLA folds it), isolating the
            # per-slot dynamic extraction cost. Non-benchmark runs only.
            if "sharedext" in engine._ABLATE:
                u0 = v0 = jnp.int32(0)
            else:
                u0 = jnp.clip(jnp.round(h[0]).astype(jnp.int32) - R,
                              0, W - W2)
                v0 = jnp.clip(jnp.round(h[1]).astype(jnp.int32) - R,
                              0, H - W2)
            if _WIN_FORM == "chain":
                # Two chained single-axis cuts: the row strip depends
                # only on v0 (batched offset on the SUBLANE dim), the
                # column cut only on u0 — each lowers as a 1-D gather
                # under the slot vmap instead of one 2-D gather.
                strip = jax.lax.dynamic_slice(
                    plane, (jnp.int32(0), v0, jnp.int32(0)),
                    (2, RG, plane.shape[2]))
                reg = jax.lax.dynamic_slice(
                    strip, (jnp.int32(0), jnp.int32(0), u0), (2, RG, RG))
            else:
                reg = jax.lax.dynamic_slice(plane, (jnp.int32(0), v0, u0),
                                            (2, RG, RG))
            win = reg[0, r:r + W2, r:r + W2]
            vals, idx = jax.lax.top_k(win.reshape(-1), C)
            wy_, wx_ = idx // W2, idx % W2
            cu = (u0 + wx_).astype(img.dtype)
            cv = (v0 + wy_).astype(img.dtype)
            nu = jnp.stack([cu - h[0], cv - h[1]], axis=-1)     # (C, 2)
            gate_ = (vals > 0.0) & (mahalanobis2(nu, Si) < chi2)
            return cu, cv, gate_, wy_, wx_, reg[1], u0, v0

        cu, cv, gate, wy, wx, regions, u0s, v0s = \
            jax.vmap(cands_shared)(h_pred, S)
        cap = h_pred.shape[0]
        if "describe" in engine._ABLATE:
            d = jnp.ones((cap, C, descriptor.N_BITS), img.dtype)
        else:
            d = descriptor.describe_regions(
                regions, u0s - r, v0s - r, u0s, v0s, wy, wx, H, W)

        z, dist, found = jax.vmap(pick)(descr_init, d, gate, cu, cv)
        return z, dist, found & visible

    def cands(h, Si):
        # Attribution knobs (EKF_ABLATE): "winext" pins the window slice
        # to a constant offset (isolates the per-slot dynamic extraction);
        # "topk" replaces the top-k with the first C entries (isolates
        # lax.top_k). Non-benchmark runs only.
        if "winext" in engine._ABLATE:
            win = jax.lax.dynamic_slice(score, (0, 0), (W2, W2))
            u0 = v0 = jnp.int32(0)
        else:
            win, u0, v0 = ncc.extract_patch_anchored(score, h, R)
        if "topk" in engine._ABLATE:
            vals = win.reshape(-1)[:C]
            idx = jnp.arange(C)
        else:
            vals, idx = jax.lax.top_k(win.reshape(-1), C)
        wy, wx = idx // W2, idx % W2
        cu = (u0 + wx).astype(img.dtype)     # candidate pixel coords
        cv = (v0 + wy).astype(img.dtype)
        nu = jnp.stack([cu - h[0], cv - h[1]], axis=-1)      # (C, 2)
        gate = (vals > 0.0) & (mahalanobis2(nu, Si) < chi2)
        return cu, cv, gate, v0 + wy, u0 + wx, wy, wx

    cu, cv, gate, yy, xx, wy, wx = jax.vmap(cands)(h_pred, S)  # (CAP, C)
    cap = h_pred.shape[0]
    if "describe" in engine._ABLATE:
        d = jnp.ones((cap, C, descriptor.N_BITS), img.dtype)
    elif descriptor._MANY_FORM == "onehot":
        # Per-SLOT region cut + exact one-hot patch extraction as
        # matmuls, no per-candidate gather — descriptor.describe_windows.
        d = descriptor.describe_windows(sm, h_pred, wy, wx, R)
    else:
        # ONE flat describe over all CAP·C candidates (patch-slice +
        # selector matmul) instead of per-slot 2-D-index gathers under
        # the vmap — see descriptor.describe_many.
        d = descriptor.describe_many(
            sm, jnp.stack([yy, xx], axis=-1).reshape(cap * C, 2)
        ).reshape(cap, C, -1)                            # (CAP, C, N_BITS)

    z, dist, found = jax.vmap(pick)(descr_init, d, gate, cu, cv)
    return z, dist, found & visible


def select_new_feature_pixels(img: jnp.ndarray, pred_px: jnp.ndarray,
                              pred_mask: jnp.ndarray, cfg: EngineConfig):
    """Top-K FAST corners outside exclusion disks around predicted features
    and off the border. Returns (uv (K,2), mask (K,))."""
    v = cfg.vision
    score = fast.non_max_suppress(
        fast.fast_score(img, v.fast_threshold, v.fast_arc))
    H, W = img.shape
    yy = jnp.arange(H, dtype=img.dtype)[:, None]
    xx = jnp.arange(W, dtype=img.dtype)[None, :]
    border_ok = ((yy >= BORDER) & (yy < H - BORDER)
                 & (xx >= BORDER) & (xx < W - BORDER))
    score = score * border_ok
    # Candidates-first exclusion: take the top (K + CAP) corners, THEN
    # test their distances against the predicted features — (K+CAP, CAP)
    # instead of the all-pairs (H·W, CAP) distance field (which
    # materialized ~2 GB/frame at the pixels-bench operating point).
    # Exact unless more than CAP suppressed corners fall INSIDE the
    # exclusion disks while ranking above still-clear true picks — with
    # non-max suppression and disks of radius ~2·NMS that would need an
    # implausible corner pile-up; the reference picks a single best
    # corner per deficit from the same masked map (initialize_features.m).
    k = cfg.map.max_new_per_step
    cand = k + pred_px.shape[0]
    yx, vals = fast.top_corners(score, cand)            # (cand, 2)
    d2 = ((yx[:, 0:1].astype(img.dtype) - pred_px[None, :, 1]) ** 2
          + (yx[:, 1:2].astype(img.dtype) - pred_px[None, :, 0]) ** 2)
    d2 = jnp.where(pred_mask[None, :], d2, jnp.inf)
    clear = jnp.min(d2, axis=-1) > v.exclusion_radius ** 2
    vals = vals * clear
    order = jnp.argsort(-vals)[:k]
    yx, vals = yx[order], vals[order]
    uv = jnp.stack([yx[:, 1], yx[:, 0]], axis=-1).astype(img.dtype)
    return uv, vals > 0.0


def store_appearance(app: Appearance, state: FilterState, img: jnp.ndarray,
                     uv: jnp.ndarray, assigned: jnp.ndarray) -> Appearance:
    """Write the 41x41 patch + pose + pixel + binary descriptor for
    candidates that landed in a slot (add_feature_to_info_vector.m
    patch/pose/FREAK capture, initialize_a_feature.m:51-54)."""
    x_cam = state.x[:CAM_DIM]
    pose = jnp.concatenate([x_cam[0:3], x_cam[3:7]])
    # Descriptors for all candidates at once (one smoothing pass).
    yx = jnp.stack([uv[:, 1], uv[:, 0]], axis=-1).astype(jnp.int32)
    descrs = descriptor.describe(img, yx)                  # (K, N_BITS)

    def body(k, a):
        slot = assigned[k]
        ok = slot >= 0
        s = jnp.clip(slot, 0, a.patches.shape[0] - 1)
        patch = ncc.extract_patch(img, uv[k], INIT_PATCH_HALF)
        return Appearance(
            patches=a.patches.at[s].set(
                jnp.where(ok, patch, a.patches[s])),
            init_pose=a.init_pose.at[s].set(
                jnp.where(ok, pose, a.init_pose[s])),
            init_px=a.init_px.at[s].set(
                jnp.where(ok, uv[k], a.init_px[s])),
            descr=a.descr.at[s].set(
                jnp.where(ok, descrs[k], a.descr[s])))

    return jax.lax.fori_loop(0, uv.shape[0], body, app)


@ekf.f32_matmuls
def step_image(state: FilterState, app: Appearance, img: jnp.ndarray,
               key: jax.Array, cfg: EngineConfig):
    """One full SLAM frame from PIXELS (the mono_slam.m per-step pipeline
    with the toolbox matcher replaced). Returns (state, app, StepInfo).

    Stage order matches mono_slam.m:50-82 — map management, ONE EKF
    prediction shared by the matcher and the filter (search_IC_matches
    reuses ekf_prediction's x_k_km1), association/RANSAC/updates, then
    feature initialization from the current frame."""
    state = mapman.manage(state, cfg)                      # stage 1
    x_prior, P_prior = ekf.predict(state.x, state.P, cfg.filter)  # stage 2
    z, z_valid, h_pred, pred_vis, r_needed = measure_at_prior(
        state, app, img, x_prior, P_prior, cfg)            # stage 3 matching
    state, visible, ic, info = engine.step_core_from_prior(
        state, x_prior, P_prior, z, z_valid, key, cfg)     # stages 3-7
    info = info.replace(search_r_needed=r_needed)
    # Feature initialization from the current image when starved.
    need = jnp.sum(ic) < cfg.map.min_features_in_image
    uv, cand = select_new_feature_pixels(img, h_pred, pred_vis, cfg)
    k = jnp.arange(uv.shape[0])
    deficit = jnp.maximum(cfg.map.min_features_in_image - jnp.sum(ic), 0)
    take = cand & (k < deficit) & need
    frame_ids = jnp.full((uv.shape[0],), -1, jnp.int32)  # no gt ids here
    state, assigned = mapman.add_features_batch(
        state, uv, take, frame_ids, cfg)
    app = store_appearance(app, state, img, uv, assigned)
    return state, app, info


# --- software-pipelined (staggered) image-path driver ------------------------
#
# Same scheme as engine.run_sequence_staggered: the image
# step's phase 1 (manage, predict, the MATCHER — warp/FAST/describe/NCC,
# the dominant cost of the pixels path — gates, RANSAC) of one batch half
# is schedulable against phase 2 (the matmul/memory-heavy updates + feature
# init + appearance store) of the other. Per-instance math is identical
# (tests/test_vision.py pins bit-equality with the step_image loop).

@pytree.dataclass
class ImagePhase1Carry:
    core: engine.Phase1Carry
    app: Appearance
    h_pred: jnp.ndarray
    pred_vis: jnp.ndarray
    r_needed: jnp.ndarray


@ekf.f32_matmuls
def step_image_phase1(state: FilterState, app: Appearance, img: jnp.ndarray,
                      key: jax.Array, cfg: EngineConfig) -> ImagePhase1Carry:
    """Stages 1-4 of step_image: manage, ONE shared prediction, the
    appearance matcher, gates and RANSAC."""
    state = mapman.manage(state, cfg)
    x_prior, P_prior = ekf.predict(state.x, state.P, cfg.filter)
    z, z_valid, h_pred, pred_vis, r_needed = measure_at_prior(
        state, app, img, x_prior, P_prior, cfg)
    core = engine.gates_phase(state, x_prior, P_prior, z, z_valid, key, cfg)
    return ImagePhase1Carry(core, app, h_pred, pred_vis, r_needed)


@ekf.f32_matmuls
def step_image_phase2(c: ImagePhase1Carry, img: jnp.ndarray,
                      cfg: EngineConfig):
    """Stages 5-8 of step_image: updates, bookkeeping, feature init from
    the current image, appearance store. Returns (state, app, StepInfo)."""
    state, ic, info = engine.update_phase(c.core, cfg)
    info = info.replace(search_r_needed=c.r_needed)
    need = jnp.sum(ic) < cfg.map.min_features_in_image
    uv, cand = select_new_feature_pixels(img, c.h_pred, c.pred_vis, cfg)
    k = jnp.arange(uv.shape[0])
    deficit = jnp.maximum(cfg.map.min_features_in_image - jnp.sum(ic), 0)
    take = cand & (k < deficit) & need
    frame_ids = jnp.full((uv.shape[0],), -1, jnp.int32)
    state, assigned = mapman.add_features_batch(
        state, uv, take, frame_ids, cfg)
    app = store_appearance(c.app, state, img, uv, assigned)
    return state, app, info


def image_phase_split_supported(cfg: EngineConfig) -> bool:
    """Whether run_images_staggered's two-phase split covers this
    configuration. engine.phase_split_supported also excludes the fused
    sim kernels, which step_image never routes through — this checks
    only the conditions that apply to the image path. Drivers (bench.py)
    use it to fall back to the plain vmap driver instead of tripping the
    ValueError below when attribution knobs (EKF_ABLATE / EKF_DEFER /
    EKF_UPDATE=rows) are set."""
    return not (cfg.filter.share_pht or cfg.filter.use_iterated_update
                or engine._DEFER or engine._ABLATE or ekf._ABLATE
                or ekf._UPDATE == "rows")


def run_images_staggered(states: FilterState, apps: Appearance,
                         imgs: jnp.ndarray, keys: jax.Array,
                         cfg: EngineConfig, chains: int = 2):
    """Batched image-sequence driver with the batch split into `chains`
    slices a phase out of step (engine.staggered_chains_drive — one
    chain's matcher half schedules against another's update half).
    states/apps: leading batch axis (B divisible by chains); imgs:
    (T, H, W) shared frames; keys: (B,) one per instance, split into
    per-frame keys exactly as the step_image scan does. Returns
    (final_states, final_apps, traj (B, T, 13), infos (B, T) fields).
    """
    if not image_phase_split_supported(cfg):
        raise ValueError("staggered image driver requires the default "
                         "engine path")
    B = states.x.shape[0]
    assert B % chains == 0, "staggered driver needs B divisible by chains"
    b = B // chains
    T = imgs.shape[0]

    fkeys = jax.vmap(lambda k: jax.random.split(k, T))(keys)   # (B, T)
    keys_list = [jnp.swapaxes(fkeys[j * b:(j + 1) * b], 0, 1)
                 for j in range(chains)]
    states_list = [
        (jax.tree.map(lambda a, j=j: a[j * b:(j + 1) * b], states),
         jax.tree.map(lambda a, j=j: a[j * b:(j + 1) * b], apps))
        for j in range(chains)]

    vp1 = jax.vmap(lambda st, ap, im, k: step_image_phase1(st, ap, im, k,
                                                           cfg),
                   in_axes=(0, 0, None, 0))
    vp2 = jax.vmap(lambda c, im: step_image_phase2(c, im, cfg),
                   in_axes=(0, None))

    def p1(sa, im, k):
        return vp1(sa[0], sa[1], im, k)

    def p2(c, im):
        st, app, info = vp2(c, im)
        return (st, app), (info, st.x[:, :13])

    finals, outs = engine.staggered_chains_drive(states_list, p1, p2,
                                                 imgs, keys_list)

    def _assemble(stacked):
        return jnp.swapaxes(stacked, 0, 1)

    traj = jnp.concatenate([_assemble(o[1]) for o in outs], axis=0)
    infos = jax.tree.map(
        lambda *parts: jnp.concatenate([_assemble(p) for p in parts],
                                       axis=0),
        *[o[0] for o in outs])
    final = jax.tree.map(lambda *parts: jnp.concatenate(parts, axis=0),
                         *[sa[0] for sa in finals])
    final_apps = jax.tree.map(lambda *parts: jnp.concatenate(parts,
                                                             axis=0),
                              *[sa[1] for sa in finals])
    return final, final_apps, traj, infos
