"""Measurement model over all landmark slots at once (L3).

Vectorized (slot-axis) re-design of the reference's per-feature loops:
* prediction + visibility gates — predict_camera_measurements.m:1-28,
  hi_inverse_depth.m:1-57 (camera-frame transform, ±60° FoV gate, distorted
  in-image gate), hi_cartesian.m:1-49. Empty-return gating becomes a boolean
  `visible` mask.
* analytic Jacobians — calculate_Hi_inverse_depth.m:1-165 /
  calculate_Hi_cartesian.m:1-115, produced as per-slot blocks
  H_xv (CAP,2,13), H_y (CAP,2,6) and assembled into the dense padded
  (2·CAP, D) matrix by a block-diagonal einsum (the reference scatters into
  a dynamically-sized sparse row pair instead).
* per-slot innovation covariance S_i = H_i P Hᵀ_i + R_i
  (search_IC_matches.m:8) computed for all slots with one batched contraction.

Every function treats a cartesian landmark as occupying the first 3 dims of
its 6-wide slot (state.py layout); the angular/rho H columns are zeroed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

import os

from ekf_slam_tpu.config import CAM_DIM, CameraConfig, EngineConfig
from ekf_slam_tpu.filter.ekf import f32_matmuls as _f32_matmuls
from ekf_slam_tpu.filter.state import FilterState
from ekf_slam_tpu.ops import camera as cam_ops
from ekf_slam_tpu.ops import quaternion as quat

# Slot-diagonal extraction form for innovation_covariances (A/B knob;
# see _slot_diag_blocks): "flatgather" = flat-index gather (pays a
# batch-minor relayout copy of P, ~4.9M estimated cycles/call) —
# MEASURED BEST of round 2c; "blockreduce" = block-diag mask + single
# slot'-axis reduce (no gather, each element read once); "reduce" =
# one-hot multiply-reduce over the landmark rows, which avoids the copy
# but re-visits each row per selected column and costs ~46M estimated
# cycles (r2f HLO dump) — kept only as the A/B record of why the copy
# is the cheaper evil there.
_SDIAG = os.environ.get("EKF_SDIAG", "flatgather")

# Trace-time override (parallel/sharded_filter.py traces its tensor-
# parallel step with "dotsel": the flat P.reshape(-1) gather merges the
# row-SHARDED dim of P and forces a full-P all-gather per S assembly;
# dotsel's one-hot contraction partitions row-locally).
_SDIAG_OVERRIDE = [None]


class sdiag_override:
    """Context manager pinning the slot-diag extraction form while
    tracing a program."""

    def __init__(self, form):
        self.form = form

    def __enter__(self):
        self.prev = _SDIAG_OVERRIDE[0]
        _SDIAG_OVERRIDE[0] = self.form

    def __exit__(self, *exc):
        _SDIAG_OVERRIDE[0] = self.prev

# Jacobian-chain contraction form (A/B knob; see jacobians): "chain3" =
# three separate (CAP,2,3)x(CAP,3,k) products, "fused" = one contraction
# against the concatenated chain factors. Bit-identical outputs; the
# probe target is the linearize small-op soup (~15% of the sim step,
# runs/r2n ablation).
_JACFORM = os.environ.get("EKF_JACFORM", "chain3")

# Per-slot S assembly form (A/B knob; see innovation_covariances):
# "aos" = the (CAP, 2, k) einsum forms — MEASURED BEST (9717.6 vs
# 8360.7 steps/s for soa on the real bench, despite the einsums'
# padded small-minor-dim operands ranking high in the compiler's
# estimated_cycles; the many small SoA kernels lower worse than the
# fused einsum forms). "soa" = split pixel components into 2-D
# (CAP, k) arrays — kept as the A/B record.
_S1FORM = os.environ.get("EKF_S1FORM", "aos")


def camera_frame_points(x: jnp.ndarray, slots: jnp.ndarray,
                        cartesian: jnp.ndarray) -> jnp.ndarray:
    """h_C for every slot: R_cw((y−t)ρ + m) for inverse-depth
    (hi_inverse_depth.m:16), R_cw(y−t) for cartesian (hi_cartesian.m:8).

    x: (D,) state; slots: (CAP, 6); cartesian: (CAP,) bool. Returns (CAP, 3).
    """
    t_wc = x[0:3]
    R_wc = quat.q2r(x[3:7])
    y3 = slots[:, 0:3]
    theta, phi, rho = slots[:, 3], slots[:, 4], slots[:, 5]
    mi = quat.azel_to_ray(theta, phi)                      # (CAP, 3)
    v_id = (y3 - t_wc) * rho[:, None] + mi
    v_cart = y3 - t_wc
    v = jnp.where(cartesian[:, None], v_cart, v_id)
    return v @ R_wc                                        # R_wcᵀ v, batched


def predict_measurements(x: jnp.ndarray, active: jnp.ndarray,
                         cartesian: jnp.ndarray, cfg: EngineConfig):
    """Project every active slot; gate by FoV and image bounds.

    Returns (h (CAP,2) distorted pixels, visible (CAP,) bool, hc (CAP,3)).
    Matches hi_*'s gating: |atan2(hx,hz)|, |atan2(hy,hz)| <= 60° and
    0 < u < nCols, 0 < v < nRows (hi_inverse_depth.m:37-57).
    """
    cam = cfg.camera
    cap = active.shape[0]
    slots = x[CAM_DIM:].reshape(cap, 6)
    hc = camera_frame_points(x, slots, cartesian)
    lim = jnp.deg2rad(jnp.asarray(cfg.matching.fov_limit_deg, x.dtype))
    ax = jnp.arctan2(hc[:, 0], hc[:, 2])
    ay = jnp.arctan2(hc[:, 1], hc[:, 2])
    in_fov = (jnp.abs(ax) <= lim) & (jnp.abs(ay) <= lim)
    # Guard the projection division for slots behind the camera (the
    # reference early-returns before projecting; we project a safe dummy).
    hc_safe = jnp.where(in_fov[:, None], hc,
                        jnp.array([0.0, 0.0, 1.0], x.dtype))
    h = cam_ops.distort(cam_ops.project(hc_safe, cam), cam)
    in_image = ((h[:, 0] > 0) & (h[:, 0] < cam.n_cols)
                & (h[:, 1] > 0) & (h[:, 1] < cam.n_rows))
    visible = active & in_fov & in_image
    return h, visible, hc


def jacobians(x: jnp.ndarray, h: jnp.ndarray, hc: jnp.ndarray,
              cartesian: jnp.ndarray, cam: CameraConfig):
    """Analytic per-slot measurement Jacobians.

    Returns H_xv (CAP, 2, 13), H_y (CAP, 2, 6). The chain is
    dh_dhrl = dhd_dhu · dhu_dhrl with dhd_dhu = inv(jacob_undistort(h))
    (calculate_Hi_inverse_depth.m:113-156), then
      inverse-depth: dhrl_drw = −R_cw ρ; dhrl_dqwr = dRq(q̄, (y−r)ρ+m)·dq̄/dq;
                     dhrl_dy = [ρ R_cw, R_cw ∂m/∂θ, R_cw ∂m/∂φ, R_cw(y−r)]
                     (calculate_Hi_inverse_depth.m:44-108)
      cartesian:     dhrl_drw = −R_cw; dhrl_dy = R_cw
                     (calculate_Hi_cartesian.m:31-41).
    """
    dtype = x.dtype
    cap = cartesian.shape[0]
    slots = x[CAM_DIM:].reshape(cap, 6)
    rw, qwr = x[0:3], x[3:7]
    R_wc = quat.q2r(qwr)
    R_cw = R_wc.T
    y3 = slots[:, 0:3]
    theta, phi, rho = slots[:, 3], slots[:, 4], slots[:, 5]
    mi = quat.azel_to_ray(theta, phi)

    dh_dhrl = cam_ops.jacob_distort(h, cam) @ cam_ops.dhu_dhrl(hc, cam)  # (CAP,2,3)

    # ∂h_C/∂r_W
    dhrl_drw_id = -R_cw[None, :, :] * rho[:, None, None]
    dhrl_drw_cart = jnp.broadcast_to(-R_cw, (cap, 3, 3))
    dhrl_drw = jnp.where(cartesian[:, None, None], dhrl_drw_cart, dhrl_drw_id)

    # ∂h_C/∂q_WR = dRq_times_a_by_dq(q̄, a) · diag(1,−1,−1,−1)
    a_id = (y3 - rw) * rho[:, None] + mi
    a_cart = y3 - rw
    a = jnp.where(cartesian[:, None], a_cart, a_id)
    dhrl_dq = quat.dRq_times_a_by_dq(
        jnp.broadcast_to(quat.qconj(qwr), (cap, 4)), a) @ quat.dqbar_dq(dtype)

    # ∂h_C/∂y — inverse-depth: 6 columns; cartesian: 3 columns (rest zero).
    dmi_dth = quat.dm_dtheta(theta, phi) @ R_wc      # R_cw·dm, batched
    dmi_dph = quat.dm_dphi(theta, phi) @ R_wc
    ry = (y3 - rw) @ R_wc                            # R_cw (y − r)
    dhrl_dy_id = jnp.concatenate([
        R_cw[None] * rho[:, None, None],
        dmi_dth[:, :, None], dmi_dph[:, :, None], ry[:, :, None]], axis=-1)
    dhrl_dy_cart = jnp.concatenate([
        jnp.broadcast_to(R_cw, (cap, 3, 3)), jnp.zeros((cap, 3, 3), dtype)],
        axis=-1)
    dhrl_dy = jnp.where(cartesian[:, None, None], dhrl_dy_cart, dhrl_dy_id)

    if _JACFORM == "fused":
        # ONE batched (CAP,2,3)x(CAP,3,13) contraction instead of three
        # (the "small-op soup" probe, docs/BACKLOG.md #3): concatenate the
        # camera/quaternion/slot chain factors on the output axis so the
        # pixel-chain multiply touches its operands once. Each output
        # element is the same 3-term dot either way — bit-identical
        # (tests/test_layout_forms.py pins it); A/B via EKF_JACFORM.
        rhs = jnp.concatenate([dhrl_drw, dhrl_dq, dhrl_dy], axis=-1)
        Hb = dh_dhrl @ rhs                            # (CAP, 2, 13)
        H_xv = jnp.concatenate([
            Hb[:, :, :7], jnp.zeros((cap, 2, 6), dtype)], axis=-1)
        return H_xv, Hb[:, :, 7:]

    H_xv = jnp.concatenate([
        dh_dhrl @ dhrl_drw,
        dh_dhrl @ dhrl_dq,
        jnp.zeros((cap, 2, 6), dtype)], axis=-1)
    H_y = dh_dhrl @ dhrl_dy
    return H_xv, H_y


@_f32_matmuls
def innovation_covariances(P: jnp.ndarray, H_xv: jnp.ndarray,
                           H_y: jnp.ndarray, sigma_z: float):
    """Per-slot S_i = H_i P H_iᵀ + σ_z² I₂ for all slots at once
    (search_IC_matches.m:8), exploiting H_i's two-block sparsity.

    S_i = Hxvᵢ P₁₁ Hxvᵢᵀ + Hxvᵢ P₁ᵧᵢ Hyᵢᵀ + (·)ᵀ + Hyᵢ Pᵧᵢᵧᵢ Hyᵢᵀ + R.
    Returns (CAP, 2, 2).
    """
    from ekf_slam_tpu.filter.ekf import p_compute
    P = p_compute(P)
    cap = H_xv.shape[0]
    Pyy = _slot_diag_blocks(P, cap)
    if _S1FORM != "soa":
        return innovation_covariances_from_blocks(
            P[:CAM_DIM, :], Pyy, H_xv, H_y, sigma_z)
    P11 = P[:CAM_DIM, :CAM_DIM]
    # Cross/diag blocks per slot, gathered by reshape (slots are regular).
    P1y = P[:CAM_DIM, CAM_DIM:].reshape(CAM_DIM, cap, 6).transpose(1, 0, 2)
    # SoA assembly: the (CAP, 2, k) einsum operands carry minor dims
    # (2, k<=13) that tile-pad to (8, 128) and lower to many small padded
    # kernels (~17.5M estimated cycles across t1-t3 in the r2f HLO dump).
    # Splitting the pixel components u/v into clean 2-D (CAP, k) arrays
    # keeps every intermediate unpadded-in-sublanes; the three quadratic
    # forms become two (CAP,13)x(13,13) dots, two batched matvecs and
    # eight fused multiply-reduces over (CAP, k).
    Hu, Hv = H_xv[:, 0, :], H_xv[:, 1, :]                  # (CAP, 13)
    Gu, Gv = H_y[:, 0, :], H_y[:, 1, :]                    # (CAP, 6)
    Wu, Wv = Hu @ P11, Hv @ P11                            # (CAP, 13)
    Bu = jnp.einsum("cj,cjk->ck", Hu, P1y)                 # (CAP, 6)
    Bv = jnp.einsum("cj,cjk->ck", Hv, P1y)
    Cu = jnp.einsum("cj,cjk->ck", Gu, Pyy)                 # (CAP, 6)
    Cv = jnp.einsum("cj,cjk->ck", Gv, Pyy)
    r = jnp.asarray(sigma_z, P.dtype) ** 2
    s00 = (jnp.sum(Wu * Hu, -1) + 2.0 * jnp.sum(Bu * Gu, -1)
           + jnp.sum(Cu * Gu, -1) + r)
    s11 = (jnp.sum(Wv * Hv, -1) + 2.0 * jnp.sum(Bv * Gv, -1)
           + jnp.sum(Cv * Gv, -1) + r)
    s01 = (jnp.sum(Wu * Hv, -1) + jnp.sum(Bu * Gv, -1)
           + jnp.sum(Bv * Gu, -1) + jnp.sum(Cu * Gv, -1))
    return jnp.stack([jnp.stack([s00, s01], -1),
                      jnp.stack([s01, s11], -1)], -2)      # (CAP, 2, 2)


@_f32_matmuls
def innovation_covariances_from_blocks(top13: jnp.ndarray, Pyy: jnp.ndarray,
                                       H_xv: jnp.ndarray, H_y: jnp.ndarray,
                                       sigma_z: float):
    """Per-slot S from precomputed covariance blocks: top13 = the 13
    camera rows (13, D) in COMPUTE dtype, Pyy = (CAP, 6, 6) slot
    diagonal blocks. This is all of P the per-slot S formula touches, so
    the deferred-update engine path (EKF_DEFER) can feed blocks built
    from the LI update's folded-tail factors instead of a materialized
    posterior P. The (CAP, 2, k) einsum (aos) forms."""
    cap = H_xv.shape[0]
    P11 = top13[:, :CAM_DIM]
    P1y = top13[:, CAM_DIM:CAM_DIM + 6 * cap].reshape(
        CAM_DIM, cap, 6).transpose(1, 0, 2)
    t1 = jnp.einsum("nij,jk,nlk->nil", H_xv, P11, H_xv)
    t2 = jnp.einsum("nij,njk,nlk->nil", H_xv, P1y, H_y)
    t3 = jnp.einsum("nij,njk,nlk->nil", H_y, Pyy, H_y)
    R = (sigma_z ** 2) * jnp.eye(2, dtype=top13.dtype)
    return t1 + t2 + jnp.swapaxes(t2, -1, -2) + t3 + R


def _slot_diag_blocks(P: jnp.ndarray, cap: int) -> jnp.ndarray:
    """(CAP, 6, 6) diagonal landmark blocks of P.

    A one-hot column selection fused into ONE multiply-reduce pass over the
    landmark rows' bitcast view — element (c,i,j) sits at row 13+6c+i, col
    13+6c+j. Two earlier forms both paid full-P relayout copies: 2-D-index
    advanced indexing materialized transposed copies of the whole (6·CAP)²
    map block, and the flat-index gather forced a batch-minor copy of all of
    P per call. The iota-compare selector and the multiply both fuse into
    the reduce, so nothing beyond the (6·CAP, D) row read materializes (the
    reduce visits each row once per selected column k, so the A/B vs the
    flat gather is traffic-shape dependent; EKF_SDIAG picks the form:
    "reduce" | "flatgather")."""
    D = P.shape[0]
    sdiag = _SDIAG_OVERRIDE[0] or _SDIAG
    if sdiag == "flatgather":
        flat = P.reshape(-1)
        c = jnp.arange(cap)[:, None, None]
        ij = (jnp.arange(6)[:, None] * D + jnp.arange(6)[None, :])[None]
        base = (CAM_DIM + 6 * c) * D + CAM_DIM + 6 * c
        return flat[base + ij]
    if sdiag == "dotsel":
        # Column selection as a batched dot against a CONSTANT
        # (CAP, 6, D) one-hot selector (loop-invariant, hoisted): reads
        # the landmark rows once in natural layout, no gather relayout.
        # Exact at any matmul precision: the selector is exact 0/1 and
        # P's values are bf16-representable in the bf16-stored fast mode.
        cap6 = 6 * cap
        Pmap = P[CAM_DIM:CAM_DIM + cap6, :].reshape(cap, 6, D)
        cols = (CAM_DIM + 6 * jnp.arange(cap)[:, None]
                + jnp.arange(6)[None, :])
        sel = (jnp.arange(D)[None, None, :]
               == cols[:, :, None]).astype(P.dtype)
        return jnp.einsum("cjd,ckd->cjk", Pmap, sel)
    if sdiag == "blockreduce":
        # Mask the map block to its block diagonal, then reduce out the
        # slot' axis of the (CAP, 6, CAP, 6) bitcast view — each element
        # is read exactly once (unlike the "reduce" form below, which
        # re-reads rows per selected column), and no gather means no
        # batch-minor relayout copy of P.
        Pm = P[CAM_DIM:CAM_DIM + 6 * cap, CAM_DIM:CAM_DIM + 6 * cap]
        eye = (jnp.arange(cap)[:, None] == jnp.arange(cap)[None, :])
        blocks = jnp.where(eye[:, None, :, None],
                           Pm.reshape(cap, 6, cap, 6), 0)
        return jnp.sum(blocks, axis=2)
    cap6 = 6 * cap
    Pmap = P[CAM_DIM:CAM_DIM + cap6, :].reshape(cap, 6, D)
    cols = CAM_DIM + 6 * jnp.arange(cap)[:, None] + jnp.arange(6)[None, :]
    sel = jnp.arange(D)[None, None, None, :] == cols[:, None, :, None]
    return jnp.sum(jnp.where(sel, Pmap[:, :, None, :], 0), axis=-1)


def dense_H(H_xv: jnp.ndarray, H_y: jnp.ndarray,
            row_mask: jnp.ndarray) -> jnp.ndarray:
    """Assemble the (2·CAP, D) dense Jacobian: camera columns from H_xv,
    block-diagonal landmark columns from H_y, masked rows zeroed.

    The reference's equivalent is the per-feature sparse row-pair insertion
    at calculate_Hi_inverse_depth.m:20-23.
    """
    cap = H_xv.shape[0]
    dtype = H_xv.dtype
    m = row_mask.astype(dtype)[:, None, None]
    Hxv = (H_xv * m).reshape(2 * cap, CAM_DIM)
    eye = jnp.eye(cap, dtype=dtype)
    Hy = jnp.einsum("nj,nck->ncjk", eye, H_y * m).reshape(2 * cap, 6 * cap)
    return jnp.concatenate([Hxv, Hy], axis=1)


@_f32_matmuls
def innovation_covariances_from_pht(pht3: jnp.ndarray, H_xv: jnp.ndarray,
                                    H_y: jnp.ndarray, sigma_z: float):
    """Per-slot S_i = H_i (P H_iᵀ) + R from precomputed gain columns
    pht3 (D, CAP, 2) — e.g. the fused kernels' P·Hᵀ output — instead of
    touching P again (search_IC_matches.m:8). Exploits H_i's two-block
    sparsity: only the 13 camera rows and slot i's own 6 rows of column i
    contribute. Returns (CAP, 2, 2). Slots whose pht columns were
    visibility-masked to zero return R alone."""
    cap = H_xv.shape[0]
    pht_cam = pht3[:CAM_DIM]                               # (13, CAP, 2)
    t1 = jnp.einsum("cik,kcj->cij", H_xv, pht_cam)
    pht_m = pht3[CAM_DIM:].reshape(cap, 6, cap, 2)
    idx = jnp.arange(cap)
    diag = pht_m[idx, :, idx, :]                           # (CAP, 6, 2)
    t2 = jnp.einsum("cik,ckj->cij", H_y, diag)
    R = (sigma_z ** 2) * jnp.eye(2, dtype=pht3.dtype)
    return t1 + t2 + R


@_f32_matmuls
def pht_slots_rows(P: jnp.ndarray, H_xv: jnp.ndarray,
                   H_y: jnp.ndarray) -> jnp.ndarray:
    """Transposed per-slot gain columns (CAP, 2, D) = Hᵢ P for every slot,
    via the symmetric row form (see pht_compact_rows): 13 camera rows feed
    one small matmul, each slot's own 6-row stripe feeds a batched (2,6)x
    (6,D) product — ONE natural-layout full-P read, no transposed-layout
    copy. pht_slots' column-major result equals this swapped to
    (D, CAP, 2)."""
    cap = H_xv.shape[0]
    D = P.shape[0]
    from ekf_slam_tpu.filter.ekf import p_compute
    cam = p_compute(P[:CAM_DIM, :])                        # (13, D)
    slot_rows = p_compute(P[CAM_DIM:, :]).reshape(cap, 6, D)
    return (jnp.einsum("cik,kd->cid", H_xv, cam)
            + jnp.einsum("cij,cjd->cid", H_y, slot_rows))


@_f32_matmuls
def pht_slots(P: jnp.ndarray, H_xv: jnp.ndarray,
              H_y: jnp.ndarray) -> jnp.ndarray:
    """P Hᵢᵀ for every slot, exploiting H's two-block sparsity: one P read
    and two short-contraction einsums instead of the dense (D, 2·CAP)
    product (which under f32-accurate matmul precision re-reads P three
    times). Returns (D, 2·CAP) flat slot-major (column 2c+j = slot c,
    pixel component j): the flat layout keeps the minor dim large — a
    (D, CAP, 2) result carries a minor dim of 2, a poor layout for
    matmuls and tiled memory — and column gathers `out[:, cols]` replace
    slot gathers with NO transpose. Rows are masked by whatever mask was
    already applied to H_xv/H_y."""
    from ekf_slam_tpu.filter.ekf import p_compute
    P = p_compute(P)
    cap = H_xv.shape[0]
    P1 = P[:, :CAM_DIM]                                    # (D, 13)
    Py = P[:, CAM_DIM:].reshape(P.shape[0], cap, 6)        # (D, CAP, 6)
    out3 = (jnp.einsum("dk,cik->dci", P1, H_xv)
            + jnp.einsum("dcj,cij->dci", Py, H_y))
    return out3.reshape(P.shape[0], 2 * cap)


@_f32_matmuls
def pht_rows_split(P: jnp.ndarray, H_xv: jnp.ndarray,
                   H_y: jnp.ndarray):
    """Row-form per-slot gain rows H·P, SPLIT by pixel component:
    returns (hp_u, hp_v), each (CAP, D) with hp_comp[c] = H_{c,comp}·P.

    The row-shaped variant of pht_slots/pht_slots_rows: every
    intermediate is a clean 2-D (CAP, D) array — no (CAP, 2, D) batch
    (small minor dims) and no
    (D, 2·CAP) transposed assembly. The slot-block contraction
    Σ_j H_y[c,·,j]·P[13+6c+j, :] is unrolled over j as six strided
    MAJOR-dim row slices of P fused with multiply-adds — a single
    natural-layout read of P's landmark rows, no gather, no dot with a
    tiny contraction dim. P must be symmetric (it is: every producer
    symmetrizes), so these rows equal pht_slots' columns
    (tests/test_layout_forms.py pins both orderings).

    H_xv (CAP,2,13) / H_y (CAP,2,6) must already carry any slot mask.
    """
    from ekf_slam_tpu.filter.ekf import p_compute
    cam = p_compute(P[:CAM_DIM, :])                        # (13, D)
    Pm = P[CAM_DIM:, :]                                    # (6CAP, D)
    out = []
    for comp in range(2):
        acc = H_xv[:, comp, :] @ cam                       # (CAP, D)
        for j in range(6):
            rows_j = p_compute(Pm[j::6, :])                # (CAP, D) view
            acc = acc + H_y[:, comp, j, None] * rows_j
        out.append(acc)
    return out[0], out[1]


@_f32_matmuls
def innovation_covariances_from_hp(hp_u: jnp.ndarray, hp_v: jnp.ndarray,
                                   H_xv: jnp.ndarray, H_y: jnp.ndarray,
                                   sigma_z: float):
    """Per-slot S_i from the split row-form gain rows (pht_rows_split):
    S_i[a,b] = hp_a[i]·H_{i,b} — the camera block is a 13-column slice,
    the slot block a per-row 6-element take_along_axis — so the S gates
    ride the hp rows already computed for RANSAC and the update instead
    of re-reading P's diagonal blocks (the previous flat-index gather
    materialized two full-P-sized reshape/layout copies per frame).
    Returns (CAP, 2, 2). H blocks must carry the same mask as the
    hp rows."""
    cap = H_xv.shape[0]
    cols = (CAM_DIM + 6 * jnp.arange(cap)[:, None]
            + jnp.arange(6)[None, :])                      # (CAP, 6)
    rows = []
    for hp in (hp_u, hp_v):
        t_cam = jnp.einsum("ck,cjk->cj", hp[:, :CAM_DIM], H_xv)
        hpy = jnp.take_along_axis(hp, cols, axis=1)        # (CAP, 6)
        t_slot = jnp.einsum("cp,cjp->cj", hpy, H_y)
        rows.append(t_cam + t_slot)                        # (CAP, 2)
    S = jnp.stack(rows, axis=1)                            # (CAP, 2, 2)
    R = (sigma_z ** 2) * jnp.eye(2, dtype=S.dtype)
    return S + R


def compact_dense_H_block(H_xv: jnp.ndarray, H_y: jnp.ndarray,
                          slots: jnp.ndarray, row_mask: jnp.ndarray,
                          cap: int) -> jnp.ndarray:
    """compact_dense_H in BLOCK row order: rows [0:M] are every selected
    slot's u-component row, rows [M:2M] the v-component rows (instead of
    interleaved u,v pairs). The EKF update is invariant to measurement
    row permutations; block order lets the row-form update gather its
    (2M, D) H·P operand as two contiguous (M, D) slices of the split hp
    arrays with ONE major-dim concat — no (M, 2, D) interleave (whose
    (2, D) minor dims tile-pad 4x). tests/test_layout_forms.py pins the
    permutation equivalence."""
    M = H_xv.shape[0]
    dtype = H_xv.dtype
    mask = row_mask.astype(dtype)[:, None]
    onehot = jax.nn.one_hot(slots, cap, dtype=dtype)        # (M, CAP)
    rows = []
    for comp in range(2):
        Hxv_c = H_xv[:, comp, :] * mask                     # (M, 13)
        Hy_c = jnp.einsum("mc,mj->mcj", onehot,
                          H_y[:, comp, :] * mask)           # (M, CAP, 6)
        rows.append(jnp.concatenate(
            [Hxv_c, Hy_c.reshape(M, 6 * cap)], axis=1))
    return jnp.concatenate(rows, axis=0)                    # (2M, D)


@_f32_matmuls
def pht_compact_rows(P: jnp.ndarray, H_xv_sel: jnp.ndarray,
                     H_y_sel: jnp.ndarray, sel: jnp.ndarray,
                     sel_mask: jnp.ndarray) -> jnp.ndarray:
    """P Hcᵀ (D, 2M) for the gathered compact update via the SYMMETRIC row
    form P Hcᵀ = (Hc P)ᵀ: Hc's support is the 13 camera rows plus the M
    selected slots' 6-row stripes of P, so Hc P is a natural-layout
    partial row read ((13+6M)/D of the matrix) instead of a dense
    multi-pass P @ Hcᵀ dot (which can also pay a full-P layout-transpose
    copy). The final transpose is of the small
    (2M, D) product. Identical math; P must be symmetric (it is: every
    producer symmetrizes)."""
    from ekf_slam_tpu.filter.ekf import p_compute
    D = P.shape[0]
    M = sel.shape[0]
    cam = p_compute(P[:CAM_DIM, :])                        # (13, D)
    cap = (D - CAM_DIM) // 6
    slot_rows = p_compute(
        P[CAM_DIM:, :].reshape(cap, 6, D)[sel])            # (M, 6, D)
    hp = (jnp.einsum("mik,kd->mid", H_xv_sel, cam)
          + jnp.einsum("mij,mjd->mid", H_y_sel, slot_rows))
    hp = hp * sel_mask[:, None, None].astype(hp.dtype)
    return hp.reshape(2 * M, D).T


def compact_dense_H(H_xv: jnp.ndarray, H_y: jnp.ndarray,
                    slots: jnp.ndarray, row_mask: jnp.ndarray,
                    cap: int) -> jnp.ndarray:
    """Dense Jacobian for a GATHERED subset of M slots: (2M, 13+6*cap).

    H_xv: (M, 2, 13), H_y: (M, 2, 6) — rows already gathered at `slots`
    (M,); row_mask (M,) zeroes inactive rows. The landmark block lands at
    column offset 6*slots[m] via a one-hot matmul (static shapes, no
    scatter). With M << CAP this shrinks the update solve from 2*CAP to 2M
    rows; identical math when every masked-in measurement is among the M
    (tests/test_compact_update.py).
    """
    M = H_xv.shape[0]
    dtype = H_xv.dtype
    mask = row_mask.astype(dtype)[:, None, None]
    Hxv = (H_xv * mask).reshape(2 * M, CAM_DIM)
    onehot = jax.nn.one_hot(slots, cap, dtype=dtype)        # (M, CAP)
    Hy = jnp.einsum("mc,mij->micj", onehot, H_y * mask)     # (M,2,CAP,6)
    return jnp.concatenate([Hxv, Hy.reshape(2 * M, 6 * cap)], axis=1)


def predict_and_linearize(x: jnp.ndarray, P: jnp.ndarray, state: FilterState,
                          cfg: EngineConfig):
    """Convenience: h, visible, H blocks, per-slot S — one call
    (= predict_camera_measurements + calculate_derivatives + the S loop of
    search_IC_matches.m:4-9)."""
    h, visible, hc = predict_measurements(x, state.active, state.cartesian, cfg)
    H_xv, H_y = jacobians(x, h, hc, state.cartesian, cfg.camera)
    S = innovation_covariances(P, H_xv, H_y, cfg.filter.sigma_z)
    return h, visible, H_xv, H_y, S
