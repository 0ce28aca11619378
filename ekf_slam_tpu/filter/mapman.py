"""Map management: masked feature add / delete / reparametrization (L3).

Where the reference grows and shrinks x and P (add_features_inverse_depth.m:
20-21, delete_a_feature.m:21-25), this module scatters into fixed slots:

* ``add_features``     — sequential lax.fori_loop over K candidate pixels,
  each taking the first free slot; covariance growth follows
  add_a_feature_covariance_inverse_depth.m:35-64 exactly (the P-append
  becomes row/col scatter: new rows = dy_dxv · P[0:13, :], new diagonal
  block = dy_dxv P₁₁ dy_dxvᵀ + dy_dhd Padd dy_dhdᵀ). Sequential order
  matters: feature j's cross-covariance with feature i<j added this step
  flows through the already-written columns, exactly like the reference's
  repeated append loop (add_features_inverse_depth.m:20-23).
* ``delete_features``  — implements the policy of the *missing*
  delete_features.m (map_management.m:7, SURVEY.md §2.9): drop a feature
  once times_measured < ratio·times_predicted after >= min predictions;
  deletion = zeroing the slot's x entries and P rows/cols + clearing masks.
* ``convert_to_cartesian`` — Civera linearity index
  L = 4σ_d cosα / d (inversedepth_2_cartesian.m:32); converts at most ONE
  feature per step (the first eligible, matching the reference's early
  return at :49), mapping P through J = [I₃ (1/ρ)∂m/∂θ (1/ρ)∂m/∂φ −m/ρ²]
  (:37-45). The slot stays 6-wide; dims 3:6 are zeroed.
* ``update_counters``  — update_features_info.m:4-18.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ekf_slam_tpu.config import CAM_DIM, EngineConfig
from ekf_slam_tpu.filter import ekf
from ekf_slam_tpu.filter.state import FilterState
from ekf_slam_tpu.ops import camera as cam_ops
from ekf_slam_tpu.ops import quaternion as quat

import os

# Conversion slot-row extraction form (A/B knob): "slotdot" contracts the
# slot axis of the (CAP, 6, D) map-row view against the conversion's
# one-hot — measured-best single-device form; "rowsel" contracts P's ROW
# axis against the (6, D) one-hot row selector, which under a row-SHARDED
# P (parallel/sharded_filter.py) reduces to a psum of a (6, D) partial
# instead of a cross-mesh gather of the whole (6·CAP, D) map block.
# Exact one-hot selections either way — bit-identical outputs.
_MGROWS = os.environ.get("EKF_MGROWS", "slotdot")
_MGROWS_OVERRIDE = [None]

# Conversion rho-variance extraction form (A/B knob): "gather" is the
# 2-D-index diagonal gather P[rho_dims, rho_dims] — under vmap it
# relayouts ALL of P to a batch-minor {0,2,1} copy (~2.6M estimated
# cycles on the f32 program, r3b HLO dump) that also feeds the slotdot
# slice; "rows" reads the CAP rho rows as a static strided slice of the
# natural-layout map block and selects the diagonal column with a
# constant one-hot mask reduce — no batch gather, no relayout. Exact
# either way (the mask is exact 0/1). A lone strided-slice rewrite lost
# in r2f (5.9M cycles) BECAUSE the batch-minor copy stayed alive for the
# slot-row extraction; "rows" + EKF_MGROWS=rowsel removes every
# batch-minor consumer of P in the conversion path.
_RHOVAR = os.environ.get("EKF_RHOVAR", "gather")


class mgrows_override:
    """Context manager pinning the conversion row-extraction form while
    tracing a program."""

    def __init__(self, form):
        self.form = form

    def __enter__(self):
        self.prev = _MGROWS_OVERRIDE[0]
        _MGROWS_OVERRIDE[0] = self.form

    def __exit__(self, *exc):
        _MGROWS_OVERRIDE[0] = self.prev


class AddParams(NamedTuple):
    """Batched feature-add P growth in closed low-rank form:
    P' = M∘P + EᵀU + UᵀE + EᵀCE (add_a_feature_covariance_inverse_depth.m:
    61-64 for all K candidates at once). Computable from the 13 camera rows
    of P alone."""
    keep_f: jnp.ndarray    # (D,) 0/1 — zeroes the newly-assigned dims
    E: jnp.ndarray         # (6K, D) one-hot rows of the new dims
    U: jnp.ndarray         # (6K, D) new rows (new columns zeroed)
    C: jnp.ndarray         # (6K, 6K) new-block covariance (incl. noise)
    state: FilterState     # x/masks/counters updated; P untouched


class ManageParams(NamedTuple):
    """The P-transform of map management (delete + one conversion) in
    closed low-rank form: P' = M∘P + E6ᵀU6 + U6ᵀE6 + E6ᵀC66E6, with
    M∘ the keep-mask outer product, applied by `apply_manage_P`."""
    keep_f: jnp.ndarray    # (D,) 0/1 — kept dims (delete + converted slot)
    E6: jnp.ndarray        # (6, D) one-hot rows of the converted slot
    U6: jnp.ndarray        # (6, D) replacement rows (masked)
    C66: jnp.ndarray       # (6, 6) replacement diagonal block
    slot: jnp.ndarray      # () int32 — converted slot (0 when do=False)
    do: jnp.ndarray        # () bool — a conversion happened
    state: FilterState     # x/masks/counters managed; P untouched


def _slot_slice(slot: jnp.ndarray) -> jnp.ndarray:
    return CAM_DIM + 6 * slot


def add_feature_jacobians(uvd: jnp.ndarray, x_cam: jnp.ndarray,
                          cfg: EngineConfig):
    """dy_dxv (6,13) and dy_dhd (6,3) for one new inverse-depth feature
    (add_a_feature_covariance_inverse_depth.m:28-57)."""
    cam = cfg.camera
    dtype = x_cam.dtype
    fku = cam.f / cam.d
    q_wc = x_cam[3:7]
    R_wc = quat.q2r(q_wc)
    uvu = cam_ops.undistort(uvd, cam)
    xyz_c = jnp.stack([-(cam.cx - uvu[..., 0]) / fku,
                       -(cam.cy - uvu[..., 1]) / fku,
                       jnp.ones_like(uvu[..., 0])], axis=-1)
    xyz_w = R_wc @ xyz_c
    Xw, Yw, Zw = xyz_w[0], xyz_w[1], xyz_w[2]
    xz2 = Xw * Xw + Zw * Zw
    r2 = xz2 + Yw * Yw
    sxz = jnp.sqrt(xz2)
    dtheta_dgw = jnp.stack([Zw / xz2, jnp.zeros_like(Zw), -Xw / xz2])
    dphi_dgw = jnp.stack([Xw * Yw / (r2 * sxz), -sxz / r2, Zw * Yw / (r2 * sxz)])
    dgw_dqwr = quat.dRq_times_a_by_dq(q_wc, xyz_c)             # (3,4)

    dy_dxv = jnp.zeros((6, CAM_DIM), dtype)
    dy_dxv = dy_dxv.at[0:3, 0:3].set(jnp.eye(3, dtype=dtype))
    dy_dxv = dy_dxv.at[3, 3:7].set(dtheta_dgw @ dgw_dqwr)
    dy_dxv = dy_dxv.at[4, 3:7].set(dphi_dgw @ dgw_dqwr)

    dyprima_dgw = jnp.stack([jnp.zeros(3, dtype), jnp.zeros(3, dtype),
                             jnp.zeros(3, dtype), dtheta_dgw, dphi_dgw])
    dgc_dhu = jnp.array([[1.0 / fku, 0.0], [0.0, 1.0 / fku], [0.0, 0.0]], dtype)
    dhu_dhd = cam_ops.jacob_undistort(uvd, cam)
    dyprima_dhd = dyprima_dgw @ R_wc @ dgc_dhu @ dhu_dhd        # (5,2)
    dy_dhd = jnp.zeros((6, 3), dtype)
    dy_dhd = dy_dhd.at[0:5, 0:2].set(dyprima_dhd)
    dy_dhd = dy_dhd.at[5, 2].set(1.0)
    return dy_dxv, dy_dhd


def add_one_feature(state: FilterState, uvd: jnp.ndarray, slot: jnp.ndarray,
                    lm_id: jnp.ndarray, cfg: EngineConfig) -> FilterState:
    """Scatter one new inverse-depth feature into `slot` (traced index)."""
    m = cfg.map
    dtype = state.x.dtype
    x_cam = state.x[:CAM_DIM]
    y = cam_ops.back_project_inverse_depth(
        uvd, x_cam[0:3], x_cam[3:7], m.initial_rho, cfg.camera)
    dy_dxv, dy_dhd = add_feature_jacobians(uvd, x_cam, cfg)
    std_pxl = jnp.asarray(cfg.filter.sigma_z, dtype)
    Padd = jnp.diag(jnp.array(
        [cfg.filter.sigma_z**2, cfg.filter.sigma_z**2, m.std_rho**2], dtype))

    off = _slot_slice(slot)
    x_new = jax.lax.dynamic_update_slice(state.x, y, (off,))
    sdt = state.P.dtype
    rows = dy_dxv @ ekf.p_compute(state.P)[:CAM_DIM, :]         # (6, D)
    diag = (dy_dxv @ ekf.p_compute(state.P)[:CAM_DIM, :CAM_DIM] @ dy_dxv.T
            + dy_dhd @ Padd @ dy_dhd.T)                         # (6, 6)
    P = jax.lax.dynamic_update_slice(state.P, rows.astype(sdt), (off, 0))
    P = jax.lax.dynamic_update_slice(P, rows.T.astype(sdt), (0, off))
    P = jax.lax.dynamic_update_slice(P, diag.astype(sdt), (off, off))
    del std_pxl
    return state.replace(
        x=x_new, P=P,
        active=state.active.at[slot].set(True),
        cartesian=state.cartesian.at[slot].set(False),
        times_predicted=state.times_predicted.at[slot].set(0),
        times_measured=state.times_measured.at[slot].set(0),
        landmark_id=state.landmark_id.at[slot].set(lm_id))


def add_features(state: FilterState, uvd: jnp.ndarray, cand_mask: jnp.ndarray,
                 lm_ids: jnp.ndarray, cfg: EngineConfig) -> FilterState:
    """Add up to K candidate features into free slots, sequentially.

    uvd: (K, 2) pixels; cand_mask: (K,) bool; lm_ids: (K,) int32
    (ground-truth handles for the sim path; pass -1s otherwise).
    """
    return add_features_assigned(state, uvd, cand_mask, lm_ids, cfg)[0]


@ekf.f32_matmuls
def add_features_batch(state: FilterState, uvd: jnp.ndarray,
                       cand_mask: jnp.ndarray, lm_ids: jnp.ndarray,
                       cfg: EngineConfig):
    """Batched equivalent of the sequential append loop
    (add_features_inverse_depth.m:20-23): all K candidates' rows, diagonal
    blocks AND their mutual cross-covariances are computed in closed form
    and scattered into P in O(1) full-matrix writes instead of K.

    Sequential append j-after-i gives P[j-block, i-block] =
    dy_j P11 dy_iᵀ (feature j reads columns feature i just wrote, which are
    P11 dy_iᵀ) — exactly the (i, j) cross term of the batch formula, so the
    result is bit-identical in exact arithmetic
    (tests/test_mapman_batch.py::test_batch_add_matches_sequential).

    Returns (state, assigned (K,) int32 slot per candidate, -1 if skipped).
    """
    p, assigned = add_params(ekf.p_compute(state.P[:CAM_DIM, :]), state,
                             uvd, cand_mask, lm_ids, cfg)
    # --- stripe write-back ---------------------------------------------------
    # The add only touches the K assigned slots' rows/cols (inactive slots'
    # stripes are already zero: fresh slots start zero, deletes zero theirs
    # in manage). Writing them as dynamic_update_slice stripes costs NO
    # full-P pass; the round-1 low-rank dot form (P' = M∘P + EᵀU + UᵀE +
    # EᵀCE) pays a full read+write plus a layout-transpose copy of P.
    # Row content:
    # U_k (cross-covariances to old dims; new columns zeroed in U) with
    # the C blocks filled in at every assigned slot's columns — exactly
    # the EᵀU/EᵀCE support, so the results are identical.
    if ekf._STRIPES != "all":
        # Single stacked dot (see apply_manage_P): Gᵀ·(Mid·G) replaces
        # EᵀU + UᵀE + EᵀCE — one full-P dot output instead of two plus a
        # transpose copy.
        Pf = ekf.p_compute(state.P)
        k = p.E.shape[0]
        dt = p.U.dtype
        eye = jnp.eye(k, dtype=dt)
        zero = jnp.zeros((k, k), dt)
        mid = jnp.block([[p.C, eye], [eye, zero]])
        G = jnp.concatenate([p.E, p.U], axis=0)            # (2k, D)
        Pn = (Pf * (p.keep_f[:, None] * p.keep_f[None, :])
              + G.T @ (mid @ G))
        return p.state.replace(P=ekf.p_store(Pn, state.P)), assigned
    return p.state.replace(
        P=_apply_add_blend(state.P, p, assigned)), assigned


def _apply_add_blend(P: jnp.ndarray, p: AddParams,
                     assigned: jnp.ndarray) -> jnp.ndarray:
    """GATHER-BLEND apply of the batched add (see apply_manage_P): the K
    new slots' rows/cols/cross-blocks are expressed as elementwise gathers
    from the small U (6K, D) and C (6K, 6K) operands, fused with the
    keep-mask pass into ONE full-P read+write — no dot (layout-copy), no
    per-instance-offset scatter (vmap serialization). U's new-slot columns
    are zeroed, C carries every new-new block, so row+col+cross gathers
    reproduce EᵀU + UᵀE + EᵀCE exactly."""
    K = assigned.shape[0]
    D = P.shape[0]
    idx = jnp.arange(D)
    # Per-dim owner: u-row index into U (6K rows), or -1 if dim not newly
    # assigned. K is small/static: K masked selects.
    uidx = jnp.full(D, -1, jnp.int32)
    for k in range(K):
        ok = assigned[k] >= 0
        off = CAM_DIM + 6 * jnp.maximum(assigned[k], 0)
        r = idx - off
        in_k = (r >= 0) & (r < 6) & ok
        uidx = jnp.where(in_k, 6 * k + r.astype(jnp.int32), uidx)
    owned = uidx >= 0                                       # (D,)
    ui = jnp.clip(uidx, 0, 6 * K - 1)
    rowpart = jnp.where(owned[:, None], p.U[ui, :], 0.0)
    colpart = jnp.where(owned[None, :], p.U.T[:, ui], 0.0)
    # chained single-axis gathers — see apply_manage_P's diagpart note
    crosspart = jnp.where(owned[:, None] & owned[None, :],
                          p.C[ui, :][:, ui], 0.0)
    out = (ekf.p_compute(P) * (p.keep_f[:, None] * p.keep_f[None, :])
           + rowpart + colpart + crosspart)
    return ekf.p_store(out, P)


def add_params(P_cam_rows: jnp.ndarray, state: FilterState,
               uvd: jnp.ndarray, cand_mask: jnp.ndarray,
               lm_ids: jnp.ndarray, cfg: EngineConfig):
    """Closed-form parameters of the batched feature add (AddParams):
    everything derivable from the 13 camera rows of P (P_cam_rows (13, D))
    — new rows are dy_dxv·P[0:13,:], the cross/diag blocks come from
    P[0:13, 0:13] (add_a_feature_covariance_inverse_depth.m:35-64).
    Returns (AddParams, assigned)."""
    m = cfg.map
    K = uvd.shape[0]
    dtype = state.x.dtype
    x_cam = state.x[:CAM_DIM]

    # --- slot assignment: k-th accepted candidate -> k-th free slot ---------
    free = ~state.active                                    # (CAP,)
    free_slots = jnp.argsort(~free)                         # free first
    n_free = jnp.sum(free)
    rank = jnp.cumsum(cand_mask.astype(jnp.int32)) - 1     # (K,) rank among accepted
    ok = cand_mask & (rank < n_free)
    slot = free_slots[jnp.clip(rank, 0, state.capacity - 1)]
    assigned = jnp.where(ok, slot.astype(jnp.int32), -1)

    # --- batched feature values + Jacobians ---------------------------------
    y = cam_ops.back_project_inverse_depth(
        uvd, jnp.broadcast_to(x_cam[0:3], (K, 3)), x_cam[3:7],
        m.initial_rho, cfg.camera)                                # (K, 6)
    dy_dxv, dy_dhd = jax.vmap(
        lambda uv: add_feature_jacobians(uv, x_cam, cfg))(uvd)    # (K,6,13/3)
    Padd = jnp.diag(jnp.array(
        [cfg.filter.sigma_z**2, cfg.filter.sigma_z**2, m.std_rho**2], dtype))

    D = state.x.shape[0]
    rows = dy_dxv @ P_cam_rows                              # (K, 6, D)
    P11 = P_cam_rows[:, :CAM_DIM]
    cross = jnp.einsum("kij,jl,mnl->kmin", dy_dxv, P11, dy_dxv)  # (K,K,6,6)
    noise = jnp.einsum("kij,jl,knl->kin", dy_dhd, Padd, dy_dhd)  # (K,6,6)
    cross = cross + noise[:, None] * jnp.eye(K, dtype=dtype)[:, :, None, None]

    cap = state.capacity
    onehot = jax.nn.one_hot(jnp.where(ok, slot, cap), cap,
                            dtype=dtype)                     # (K, CAP)
    new_slot = jnp.einsum("kc->c", onehot) > 0               # (CAP,)
    dim_new = jnp.concatenate([jnp.zeros(CAM_DIM, bool),
                               jnp.repeat(new_slot, 6)])     # (D,)
    keep_f = (~dim_new).astype(dtype)                        # (D,)

    row_flat = jnp.where(ok[:, None], CAM_DIM + 6 * slot[:, None]
                         + jnp.arange(6)[None], D).reshape(-1)   # (6K,)
    E = jax.nn.one_hot(row_flat, D, dtype=dtype)             # (6K, D)
    rows_flat = rows.reshape(6 * K, D) * keep_f[None, :]     # R̃: new cols 0
    cross_flat = cross.transpose(0, 2, 1, 3).reshape(6 * K, 6 * K)

    y_flat = y.reshape(-1)                                   # (6K,)
    x = state.x * keep_f + E.T @ y_flat

    lm_new = jnp.einsum("kc,k->c", onehot,
                        lm_ids.astype(dtype)).astype(jnp.int32)
    z32 = jnp.zeros((cap,), jnp.int32)
    new_state = state.replace(
        x=x,
        active=state.active | new_slot,
        cartesian=state.cartesian & ~new_slot,
        times_predicted=jnp.where(new_slot, z32, state.times_predicted),
        times_measured=jnp.where(new_slot, z32, state.times_measured),
        landmark_id=jnp.where(new_slot, lm_new, state.landmark_id))
    return AddParams(keep_f=keep_f, E=E, U=rows_flat, C=cross_flat,
                     state=new_state), assigned


def add_features_assigned(state: FilterState, uvd: jnp.ndarray,
                          cand_mask: jnp.ndarray, lm_ids: jnp.ndarray,
                          cfg: EngineConfig):
    """add_features that also reports the slot each candidate landed in
    (-1 when not added) — the image front-end uses the assignment to store
    per-slot appearance (add_feature_to_info_vector.m patch/pose fields)."""
    K = uvd.shape[0]
    assigned0 = jnp.full((K,), -1, jnp.int32)

    def body(k, carry):
        st, assigned = carry
        free = ~st.active
        has_free = jnp.any(free)
        slot = jnp.argmax(free)          # first free slot
        do = cand_mask[k] & has_free
        st_added = add_one_feature(st, uvd[k], slot, lm_ids[k], cfg)
        st = jax.tree.map(
            lambda a, b: jnp.where(
                jnp.reshape(do, (1,) * a.ndim), b, a), st, st_added)
        assigned = assigned.at[k].set(
            jnp.where(do, slot.astype(jnp.int32), -1))
        return st, assigned

    return jax.lax.fori_loop(0, K, body, (state, assigned0))


def delete_features(state: FilterState, cfg: EngineConfig) -> FilterState:
    """Apply the delete policy, zeroing dead slots (see module docstring)."""
    m = cfg.map
    weak = (state.times_predicted >= m.delete_min_predictions) & (
        state.times_measured.astype(state.x.dtype)
        < m.delete_measured_ratio * state.times_predicted.astype(state.x.dtype))
    drop = state.active & weak
    keep = ~drop
    dim_keep = jnp.concatenate([
        jnp.ones(CAM_DIM, bool), jnp.repeat(keep, 6)])
    x = state.x * dim_keep.astype(state.x.dtype)
    P = state.P * (dim_keep[:, None] & dim_keep[None, :]).astype(state.P.dtype)
    z32 = jnp.zeros_like(state.times_predicted)
    return state.replace(
        x=x, P=P,
        active=state.active & keep,
        cartesian=state.cartesian & keep,
        times_predicted=jnp.where(drop, z32, state.times_predicted),
        times_measured=jnp.where(drop, z32, state.times_measured),
        landmark_id=jnp.where(drop, -1, state.landmark_id))


def manage_params(state: FilterState, cfg: EngineConfig) -> ManageParams:
    """Closed-form parameters of the whole map-management P transform
    (delete policy + at-most-one inverse-depth→cartesian conversion):
    P' = M∘P + E6ᵀU6 + U6ᵀE6 + E6ᵀC66E6. The returned state carries the
    managed x/masks/counters; P is applied separately (`manage` for the
    XLA path, or fused into the predict kernel)."""
    m = cfg.map
    weak = (state.times_predicted >= m.delete_min_predictions) & (
        state.times_measured.astype(state.x.dtype)
        < m.delete_measured_ratio * state.times_predicted.astype(state.x.dtype))
    drop = state.active & weak
    keep = ~drop
    dim_keep = jnp.concatenate([
        jnp.ones(CAM_DIM, bool), jnp.repeat(keep, 6)])
    z32 = jnp.zeros_like(state.times_predicted)
    st = state.replace(
        active=state.active & keep,
        cartesian=state.cartesian & keep,
        times_predicted=jnp.where(drop, z32, state.times_predicted),
        times_measured=jnp.where(drop, z32, state.times_measured),
        landmark_id=jnp.where(drop, -1, state.landmark_id))
    return _convert_params(st, cfg, dim_keep)


def manage(state: FilterState, cfg: EngineConfig) -> FilterState:
    """delete_features + convert_to_cartesian fused into ONE full-P pass:
    the delete zeroing becomes a dim-scale folded into the conversion's
    select chain (the two stages are elementwise/select over P, so XLA
    fuses the composition — separately they each pay a full-P write).
    Equivalence: tests/test_mapman_batch.py::test_manage_equals_sequential.
    """
    p = manage_params(state, cfg)
    return p.state.replace(P=apply_manage_P(state.P, p))


@ekf.f32_matmuls
def apply_manage_P(P: jnp.ndarray, p: ManageParams) -> jnp.ndarray:
    """XLA apply of the ManageParams transform: one elementwise keep-mask
    pass over P plus 6-row/6-col/6x6 STRIPE writes for the (at most one)
    conversion. Equivalent to the low-rank form P' = M∘P + E6ᵀU6 + U6ᵀE6
    + E6ᵀC66E6 — the conversion contribution has support exactly on the
    converted slot's rows/cols, and the keep mask zeroes that stripe
    first, so add == replace. The dot form can lower to full-P layout-
    transpose copies; stripes touch 12/613 of the matrix. When do=False
    the stripes rewrite the current (masked) values — a no-op by value."""
    if ekf._STRIPES not in ("mgmt", "all"):
        # One stacked dot: EᵀU + UᵀE + EᵀCE = Gᵀ·(Mid·G) with
        # G = [E; U], Mid = [[C, I], [I, 0]] — a single full-P-sized dot
        # output into which the keep-mask pass fuses, instead of two
        # (D,D) dot outputs plus a layout-transpose copy of contribᵀ.
        k = p.E6.shape[0]
        dt = p.U6.dtype
        eye = jnp.eye(k, dtype=dt)
        zero = jnp.zeros((k, k), dt)
        mid = jnp.block([[p.C66, eye], [eye, zero]])
        G = jnp.concatenate([p.E6, p.U6], axis=0)          # (2k, D)
        return ekf.p_store(
            ekf.p_compute(P) * (p.keep_f[:, None] * p.keep_f[None, :])
            + G.T @ (mid @ G), P)
    # GATHER-BLEND form: the conversion contribution has support only on
    # the converted slot's 6-dim stripe, so express it as elementwise
    # gathers from the small U6/C66 operands and fuse everything into the
    # keep-mask pass — one full-P read+write, no dot (which paid a full-P
    # layout-transpose copy) and no dynamic-offset scatter (which
    # serializes under vmap: per-instance offsets).
    D = P.shape[0]
    idx = jnp.arange(D)
    off = CAM_DIM + 6 * p.slot
    r = idx - off
    in_s = (r >= 0) & (r < 6) & p.do                       # (D,) stripe mask
    ri = jnp.clip(r, 0, 5)
    rowpart = jnp.where(in_s[:, None], p.U6[ri, :], 0.0)
    colpart = jnp.where(in_s[None, :], p.U6.T[:, ri], 0.0)
    # chained single-axis gathers: a 2-D-index gather of shape (D, D)
    # once lowered to a flat-layout fusion that dominated the step
    diagpart = jnp.where(in_s[:, None] & in_s[None, :],
                         p.C66[ri, :][:, ri], 0.0)
    out = (ekf.p_compute(P) * (p.keep_f[:, None] * p.keep_f[None, :])
           + rowpart + colpart + diagpart)
    return ekf.p_store(out, P)


@ekf.f32_matmuls
def convert_to_cartesian(state: FilterState, cfg: EngineConfig,
                         dim_keep=None) -> FilterState:
    """Inverse-depth -> cartesian reparametrization of at most one feature
    per step (inversedepth_2_cartesian.m:1-52). `dim_keep` (D,) bool, if
    given, zero-masks deleted dims of x/P on the fly (fused delete)."""
    p = _convert_params(state, cfg, dim_keep)
    return p.state.replace(P=apply_manage_P(state.P, p))


def _convert_params(state: FilterState, cfg: EngineConfig,
                    dim_keep=None) -> ManageParams:
    m = cfg.map
    dtype = state.x.dtype
    cap = state.capacity
    if dim_keep is None:
        dim_keep = jnp.ones(state.x.shape[0], bool)
    ks = dim_keep.astype(dtype)
    x_in = state.x * ks
    slots = x_in[CAM_DIM:].reshape(cap, 6)                     # (CAP, 6)
    y3, theta, phi, rho = slots[:, 0:3], slots[:, 3], slots[:, 4], slots[:, 5]
    idx = jnp.arange(cap)
    rho_dims = CAM_DIM + 6 * idx + 5
    # Extraction form: see _RHOVAR. The 2-D-index diagonal gather
    # relayouts P to a batch-minor copy under vmap (~5.2M estimated
    # cycles, r2d HLO dump); a LONE strided-slice rewrite measured worse
    # in r2f because that copy stayed alive for the slot-row slice —
    # "rows" is only expected to win combined with EKF_MGROWS=rowsel.
    if _RHOVAR == "rows":
        rho_rows = state.P[CAM_DIM + 5:CAM_DIM + 6 * cap:6, :]  # (CAP, D)
        sel = (jnp.arange(state.P.shape[0])[None, :]
               == rho_dims[:, None]).astype(state.P.dtype)
        rho_var = (jnp.sum(rho_rows * sel, axis=-1).astype(dtype)
                   * ks[rho_dims])
    else:
        rho_var = state.P[rho_dims, rho_dims].astype(dtype) * ks[rho_dims]
    # Guard rho==0 on inactive slots.
    safe_rho = jnp.where(rho == 0, jnp.ones_like(rho), rho)
    std_d = jnp.sqrt(jnp.maximum(rho_var, 0.0)) / safe_rho**2
    mi = quat.azel_to_ray(theta, phi)
    p = y3 + mi / safe_rho[:, None]
    cam_r = state.x[0:3]
    v1 = p - y3                     # p − x_c1 (init camera position ≈ y3)
    v2 = p - cam_r                  # p − x_c2
    n1 = jnp.linalg.norm(v1, axis=-1)
    n2 = jnp.linalg.norm(v2, axis=-1)
    denom = jnp.where((n1 == 0) | (n2 == 0), jnp.ones_like(n1), n1 * n2)
    cos_alpha = jnp.sum(v1 * v2, axis=-1) / denom
    L = 4.0 * std_d * cos_alpha / jnp.where(n2 == 0, jnp.ones_like(n2), n2)

    eligible = state.active & ~state.cartesian & (L < m.linearity_threshold)
    do = jnp.any(eligible)
    slot = jnp.argmax(eligible)     # first eligible (reference converts one)

    # Scatter-free (see add_features_batch): one-hot gathers/expansions +
    # masked selects; `do` folds into the mask so the no-conversion case is
    # a no-op without a second full-state select pass.
    D = state.P.shape[0]
    onehot = jax.nn.one_hot(slot, cap, dtype=dtype) * do    # (CAP,)
    dim6 = jnp.repeat(onehot, 6)                            # (6CAP,)
    dim_mask = jnp.concatenate(
        [jnp.zeros(CAM_DIM, bool), dim6 > 0])               # (D,)

    # J = [I₃ (1/ρ)∂m/∂θ (1/ρ)∂m/∂φ −m/ρ²]  (3x6) at the chosen slot
    J = jnp.concatenate([
        jnp.eye(3, dtype=dtype),
        jnp.einsum("c,ci->i", onehot,
                   quat.dm_dtheta(theta, phi) / safe_rho[:, None])[:, None],
        jnp.einsum("c,ci->i", onehot,
                   quat.dm_dphi(theta, phi) / safe_rho[:, None])[:, None],
        jnp.einsum("c,ci->i", onehot,
                   -mi / safe_rho[:, None] ** 2)[:, None]], axis=1)

    # gather the slot's 6 P-rows as a one-hot contraction over the slot
    # axis of the landmark rows' bitcast view. This reads ALL landmark
    # rows once in natural layout as one matmul, where a dynamic_slice's
    # per-instance offset lowers (under vmap) to a batch gather behind a
    # relayout copy of P.
    # The one-hot row is exact 0/1, so this is still an exact selection;
    # precision is pinned so the matmul cannot round P's values
    # (TF32/bf16) outside an f32_matmuls scope (the recurring covariance
    # trap).
    off = CAM_DIM + 6 * slot
    # one-hot row selector of the slot's 6 dims (zero rows when do=False)
    row_flat = jnp.where(do, CAM_DIM + 6 * slot + jnp.arange(6), D)  # (6,)
    E6 = jax.nn.one_hot(row_flat, D, dtype=dtype)           # (6, D)
    # ks column-scales the gathered rows (fused delete); the chosen slot's
    # own row scale is 1 because `eligible` requires an active (kept) slot.
    if (_MGROWS_OVERRIDE[0] or _MGROWS) == "rowsel":
        # Contract P's ROW axis against the one-hot selector: exact
        # selection, partitions row-locally when P's rows are sharded
        # (see _MGROWS). E6's rows are zero when do=False, matching the
        # slotdot form's onehot*do masking.
        slot_rows = (jnp.einsum("jr,rd->jd", E6, ekf.p_compute(state.P),
                                precision=jax.lax.Precision.HIGHEST
                                ).astype(dtype) * ks[None, :])  # (6, D)
    else:
        Pmap = ekf.p_compute(state.P[CAM_DIM:CAM_DIM + 6 * cap, :]
                             ).reshape(cap, 6, D)
        slot_rows = (jnp.einsum("c,cjd->jd", onehot, Pmap,
                                precision=jax.lax.Precision.HIGHEST
                                ).astype(dtype) * ks[None, :])  # (6, D)
    new_rows3 = J @ slot_rows                               # (3, D)
    new_rows = jnp.concatenate(
        [new_rows3, jnp.zeros((3, D), dtype)], axis=0)      # (6, D)

    # diagonal block: J (slot66) Jᵀ in the top-left 3x3
    slot66 = jax.lax.dynamic_slice(slot_rows, (0, off), (6, 6))
    diag33 = J @ slot66 @ J.T
    diag66 = jnp.zeros((6, 6), dtype).at[0:3, 0:3].set(diag33)

    # additive low-rank form (see add_features_batch): the P apply is one
    # read + one write (apply_manage_P), or zero extra passes when fused
    # into the predict kernel.
    keep_f = (~dim_mask).astype(dtype) * ks
    rows_masked = new_rows * (~dim_mask).astype(dtype)[None, :]

    # x: slot <- [p, 0, 0, 0]
    new_slot_x = jnp.concatenate([
        jnp.einsum("c,ci->i", onehot, p), jnp.zeros(3, dtype)])
    x_new = x_in * (~dim_mask).astype(dtype) + E6.T @ new_slot_x

    return ManageParams(
        keep_f=keep_f, E6=E6, U6=rows_masked, C66=diag66,
        slot=slot.astype(jnp.int32), do=do,
        state=state.replace(
            x=x_new, cartesian=state.cartesian | (onehot > 0)))


def update_counters(state: FilterState, predicted: jnp.ndarray,
                    measured: jnp.ndarray) -> FilterState:
    """times_predicted += predicted; times_measured += measured
    (update_features_info.m:4-10). Masks are per-slot bools from the
    *previous* step's association, applied at the start of the next step."""
    return state.replace(
        times_predicted=state.times_predicted + predicted.astype(jnp.int32),
        times_measured=state.times_measured + measured.astype(jnp.int32))
