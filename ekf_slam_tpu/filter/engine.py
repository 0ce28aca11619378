"""The per-frame SLAM step — the reference's whole mono_slam.m hot loop
(mono_slam.m:50-82) as ONE pure jittable function over the padded state.

Stage order (mono_slam.m:53-74):
  1. map management: delete weak features, convert one inverse-depth feature
     to cartesian (map_management.m:1-35)
  2. EKF prediction (ekf_prediction.m / predict_state_and_covariance.m)
  3. measurement gathering + individual compatibility (search_IC_matches.m,
     matching.m χ² gate)
  4. 1-point RANSAC → low-innovation inliers (ransac_hypotheses.m)
  5. LI update from the prior (ekf_update_li_inliers.m)
  6. high-innovation rescue from the posterior (rescue_hi_inliers.m)
  7. HI update from the posterior (ekf_update_hi_inliers.m)
  8. counter bookkeeping (update_features_info.m) + feature initialization
     when measured < min_features (map_management.m:27-34,
     initialize_features.m) — performed at the END of the step from the
     current frame, which is the same data the reference would feed it at
     the START of the next step (its `im` still holds the previous frame at
     map_management time, mono_slam.m:53,59).

Every stage is branchless/masked; the only randomness is the RANSAC draw.
`run_sequence` wraps the step in a lax.scan over frames; Monte-Carlo
evaluation = jax.vmap of `run_sequence` over instances (the batch axis that
the benchmark scales; bench.py).

Front-end note: this module consumes dense per-landmark measurements (the
synthetic scene's ground-truth association, sim/scene.py). The image
front-end (vision/) produces the same (z, z_valid) interface from pixels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ekf_slam_tpu.config import EngineConfig
from ekf_slam_tpu.filter import association, ekf, mapman, measurement, ransac
from ekf_slam_tpu.filter.state import FilterState
from ekf_slam_tpu.sim.scene import FrameObs
from ekf_slam_tpu.utils import pytree


@pytree.dataclass
class StepInfo:
    """Per-step diagnostics (the engine's metrics surface; SURVEY.md §5)."""
    n_visible: jnp.ndarray
    n_ic: jnp.ndarray
    n_li: jnp.ndarray
    n_hi: jnp.ndarray
    ransac_support: jnp.ndarray
    # Image path only (vision/frontend.step_image): the exact χ²-reach of
    # the matcher's search this frame (max sqrt(chi2·λmax(S)) over visible
    # slots) — the in-run honesty gate for sizing the static search
    # radius; 0.0 on the sim path.
    search_r_needed: jnp.ndarray = 0.0


def gather_measurements(state: FilterState, obs: FrameObs):
    """Ground-truth association: slot i's measurement is the observation of
    the landmark it was initialized from (landmark_id). Returns
    (z (CAP,2), z_valid (CAP,))."""
    lm = state.landmark_id
    L = obs.pixels.shape[0]
    safe = jnp.clip(lm, 0, L - 1)
    z = obs.pixels[safe]
    z_valid = (lm >= 0) & obs.visible[safe] & state.active
    return z, z_valid


def _in_map_mask(state: FilterState, num_landmarks: int) -> jnp.ndarray:
    """(L,) bool — landmark already owned by an active slot."""
    lm = jnp.where(state.active, state.landmark_id, -1)
    return (jnp.zeros(num_landmarks, jnp.int32)
            .at[jnp.clip(lm, 0, num_landmarks - 1)]
            .add(jnp.where(lm >= 0, 1, 0)) > 0)


def _init_candidates(state: FilterState, obs: FrameObs, n_measured,
                     cfg: EngineConfig):
    """Candidate selection of map_management.m:27-34 + initialize_features.m:
    when fewer than min_features were measured, pick up to
    `max_new_per_step` currently visible, not-yet-mapped landmarks.
    Returns (uvd (K, 2), take (K,) bool, lm_ids (K,) int32)."""
    m = cfg.map
    L = obs.pixels.shape[0]
    need = n_measured < m.min_features_in_image
    candidate = obs.visible & ~_in_map_mask(state, L)
    # Deficit-limited, branchless top-K selection: order candidates first
    # (stable argsort of ~candidate), keep at most `deficit` of them.
    order = jnp.argsort(~candidate)                       # candidates first
    k = jnp.arange(m.max_new_per_step)
    picks = order[: m.max_new_per_step]
    deficit = jnp.maximum(m.min_features_in_image - n_measured, 0)
    take = (candidate[picks]
            & (k < deficit)
            & need)
    return obs.pixels[picks], take, picks.astype(jnp.int32)


def initialize_features(state: FilterState, obs: FrameObs, n_measured,
                        cfg: EngineConfig) -> FilterState:
    """Masked equivalent of map_management.m:27-34 + initialize_features.m:
    add the _init_candidates picks as new inverse-depth features."""
    uvd, take, lm_ids = _init_candidates(state, obs, n_measured, cfg)
    return mapman.add_features_batch(state, uvd, take, lm_ids, cfg)[0]


def step_core(state: FilterState, z: jnp.ndarray, z_valid: jnp.ndarray,
              key: jax.Array, cfg: EngineConfig):
    """Measurement-source-agnostic SLAM frame: stages 1-7 of the pipeline,
    given per-slot candidate measurements (z, z_valid) produced either by
    ground-truth association (sim path, `step`) or by the image front-end
    (vision/frontend.py). Returns (state, visible, ic, StepInfo)."""
    # -- 1. map management (delete + one reparametrization, fused) -----------
    if "manage" not in _ABLATE:
        state = mapman.manage(state, cfg)

    # -- 2. EKF prediction ----------------------------------------------------
    if "predict" in _ABLATE:
        x_prior, P_prior = state.x, state.P
    else:
        x_prior, P_prior = ekf.predict(state.x, state.P, cfg.filter)
    return step_core_from_prior(
        state, x_prior, P_prior, z, z_valid, key, cfg)


import os as _os

# Attribution-only knob (tools/): comma list of stages to
# skip inside step_core_from_prior — "ransac", "li", "hi", "lin2", "s1".
# Never set in production; bench.py waives its accuracy gates when set.
_ABLATE = frozenset(
    s for s in _os.environ.get("EKF_ABLATE", "").split(",") if s)

# EKF_DEFER=1: defer both updates' covariance applies into ONE stacked
# correction dot at the end of the frame (see step_core_from_prior).
_DEFER = _os.environ.get("EKF_DEFER", "0") == "1"

# Rescue-gate S form (A/B knob): "extract" re-extracts the camera rows +
# slot diagonals from the MATERIALIZED post-LI covariance (one
# _slot_diag_blocks pass over P_post per frame); "inc" DOWNDATES the
# blocks already extracted for the prior's S1 with the LI update's
# folded-tail factors (_deferred_hi_blocks) — extract(P + ĀB̄ᵀ) =
# extract(P) + extract(ĀB̄ᵀ) exactly, so the forms are bit-identical for
# f32/f64 storage (tests/test_engine.py pins it; bf16-P storage skips
# one storage rounding, algebraically identical). The HI update itself
# still reads the materialized P_post either way.
_S2FORM = _os.environ.get("EKF_S2FORM", "extract")


def step_core_from_prior(state: FilterState, x_prior: jnp.ndarray,
                         P_prior: jnp.ndarray, z: jnp.ndarray,
                         z_valid: jnp.ndarray, key: jax.Array,
                         cfg: EngineConfig):
    """Stages 3-7 given an already-managed state and its prediction — the
    image front-end computes the prior ONCE for both appearance matching
    and the filter (the reference's search_IC_matches also reuses the
    single ekf_prediction result, mono_slam.m:56-62)."""
    f = cfg.filter
    cap = state.capacity

    # -- 3. measurement prediction + IC gating (search_IC_matches/matching) --
    h, visible, H_xv, H_y = _linearize(x_prior, P_prior, state, cfg)[:4]
    # Row-form sharing (EKF_UPDATE=rows, the default): ONE split row-form
    # H·P read (measurement.pht_rows_split) per update phase feeds the
    # per-slot S gates, RANSAC's hypothesis apply AND the update's
    # (2M, D) H·P operand — replacing three separate P reads, with every
    # intermediate a clean (CAP, D)/(2M, D) row array (no (D, 2·CAP)
    # columns, no slot-diagonal flat gather). share_pht keeps the older
    # column-form sharing for A/B.
    # Invisible slots' hp rows are masked to zero, so their S degenerates
    # to R alone; they are gated out of IC anyway (visible=False).
    rows_mode = ekf._UPDATE == "rows" and not f.share_pht \
        and not f.use_iterated_update
    # Deferred two-update covariance tail (EKF_DEFER): both updates emit
    # folded-tail FACTORS; P is written once at the end as
    # P_prior + [Ā₁|Ā₂]·[B̄₁|B̄₂]ᵀ. The HI phase's S gates and P·Hᵀ come
    # from correction-adjusted blocks, so the posterior P is never
    # materialized between the updates (one full-P output write and one
    # prior read fewer per frame). Algebraically identical to the
    # sequential path (tests/test_engine.py pins f64 agreement).
    deferred = (_DEFER and not _ABLATE and not rows_mode
                and ekf._TAIL == "folded" and ekf._SYM == "stacked"
                and not ekf._TAIL16
                and not f.share_pht and not f.use_iterated_update
                and 0 < cfg.map.max_update_obs < cap)
    vm = visible.astype(H_xv.dtype)[:, None, None]
    hp = measurement.pht_rows_split(P_prior, H_xv * vm, H_y * vm) \
        if rows_mode else None
    pht_all = measurement.pht_slots(P_prior, H_xv * vm, H_y * vm) \
        if f.share_pht else None
    # Incremental rescue-gate blocks (EKF_S2FORM=inc): S1 comes from
    # explicitly extracted prior blocks so the post-LI S can be a cheap
    # factor DOWNDATE of the same blocks (skipping the second
    # _slot_diag_blocks pass over the materialized posterior). Gated to
    # the plain folded/stacked cols path where ekf.update can return its
    # correction factors.
    s2_inc = (_S2FORM == "inc" and not deferred and not rows_mode
              and not f.share_pht and not f.use_iterated_update
              and ekf._TAIL == "folded" and ekf._SYM == "stacked"
              and not ekf._TAIL16
              and measurement._S1FORM != "soa"
              and not _ABLATE and not ekf._ABLATE)
    top13 = pyy1 = None
    if deferred or s2_inc:
        top13 = ekf.p_compute(P_prior[:measurement.CAM_DIM, :])
        pyy1 = measurement._slot_diag_blocks(ekf.p_compute(P_prior), cap)
    if "s1" in _ABLATE:
        S = jnp.broadcast_to(jnp.eye(2, dtype=x_prior.dtype) * 4.0,
                             (cap, 2, 2))
    elif deferred or s2_inc:
        S = measurement.innovation_covariances_from_blocks(
            top13, pyy1, H_xv, H_y, f.sigma_z)
    elif hp is not None:
        S = measurement.innovation_covariances_from_hp(
            hp[0], hp[1], H_xv * vm, H_y * vm, f.sigma_z)
    elif pht_all is not None:
        S = measurement.innovation_covariances_from_pht(
            pht_all.reshape(-1, cap, 2), H_xv * vm, H_y * vm, f.sigma_z)
    else:
        S = measurement.innovation_covariances(P_prior, H_xv, H_y, f.sigma_z)
    ic = association.individually_compatible(z, z_valid, h, visible, S, cfg)

    # -- 4. 1-point RANSAC → LI inliers ---------------------------------------
    if "ransac" in _ABLATE:
        li, support = ic, jnp.sum(ic)
    else:
        li, support = ransac.run(
            x_prior, P_prior, z, h, H_xv * vm, H_y * vm, S, ic,
            state.cartesian, key, cfg, pht=pht_all, hp=hp)

    # -- 5-7 (deferred): factor-only updates, ONE covariance apply -----------
    if deferred:
        x_post, A1, B1 = _masked_update_factors(
            x_prior, P_prior, H_xv, H_y, z, h, li, cfg, P4=top13[3:7, :])
        h2, vis2, H_xv2, H_y2 = _linearize(x_post, P_prior, state, cfg)[:4]
        top13_2, pyy2 = _deferred_hi_blocks(top13, pyy1, A1, B1, cap)
        S_noR = measurement.innovation_covariances_from_blocks(
            top13_2, pyy2, H_xv2, H_y2, 0.0)
        hi = association.rescue_high_innovation(z, h2, S_noR, ic & vis2,
                                                li, cfg)
        x_post, A2, B2 = _masked_update_factors(
            x_post, P_prior, H_xv2, H_y2, z, h2, hi, cfg,
            P4=top13_2[3:7, :], corr=(A1, B1))
        P_post = _apply_stacked_factors(P_prior, A1, B1, A2, B2)
        return _step_core_epilogue(state, x_post, P_post, visible, ic,
                                   li, hi, support, cfg)

    # -- 5. LI update from the prior (ekf_update_li_inliers.m; R = I there).
    # With use_iterated_update the LI step relinearizes (Gauss-Newton IEKF,
    # the ekf_update_iterated.m intent).
    A1 = B1 = None
    if "li" in _ABLATE:
        x_post, P_post = x_prior, P_prior
    elif f.use_iterated_update:
        x_post, P_post = _masked_update_iterated(
            x_prior, P_prior, z, li, state, cfg)
    elif rows_mode:
        x_post, P_post = _masked_update_rows(
            x_prior, P_prior, hp, H_xv, H_y, z, h, li, cfg)
    elif s2_inc:
        x_post, P_post, (A1, B1) = _masked_update(
            x_prior, P_prior, H_xv, H_y, z, h, li, cfg,
            return_factors=True)
    else:
        x_post, P_post = _masked_update(
            x_prior, P_prior, H_xv, H_y, z, h, li, cfg, pht_all=pht_all)

    # -- 6. HI rescue from the posterior (rescue_hi_inliers.m) ----------------
    if "lin2" in _ABLATE:
        h2, vis2, H_xv2, H_y2 = h, visible, H_xv, H_y
    else:
        h2, vis2, H_xv2, H_y2 = _linearize(x_post, P_post, state, cfg)[:4]
    # The posterior gain rows/columns feed BOTH the rescue gates' S
    # (R=0 here, rescue_hi_inliers.m:13) and the HI update.
    vm2 = vis2.astype(H_xv2.dtype)[:, None, None]
    hp2 = measurement.pht_rows_split(P_post, H_xv2 * vm2, H_y2 * vm2) \
        if rows_mode else None
    pht_all2 = measurement.pht_slots(P_post, H_xv2 * vm2, H_y2 * vm2) \
        if f.share_pht else None
    if hp2 is not None:
        S_noR = measurement.innovation_covariances_from_hp(
            hp2[0], hp2[1], H_xv2 * vm2, H_y2 * vm2, 0.0)
    elif pht_all2 is not None:
        S_noR = measurement.innovation_covariances_from_pht(
            pht_all2.reshape(-1, cap, 2), H_xv2 * vm2, H_y2 * vm2, 0.0)
    elif s2_inc:
        # extract(P + Ā₁B̄₁ᵀ) = extract(P) + extract(Ā₁B̄₁ᵀ): the rescue
        # blocks are the S1 blocks plus a tiny factor contraction — the
        # second full-P slot-diag extraction disappears.
        top13_2, pyy2 = _deferred_hi_blocks(top13, pyy1, A1, B1, cap)
        S_noR = measurement.innovation_covariances_from_blocks(
            top13_2, pyy2, H_xv2, H_y2, 0.0)
    else:
        S_noR = measurement.innovation_covariances(P_post, H_xv2, H_y2, 0.0)
    hi = association.rescue_high_innovation(z, h2, S_noR, ic & vis2, li, cfg)

    # -- 7. HI update from the posterior (ekf_update_hi_inliers.m; R = I) -----
    if "hi" in _ABLATE:
        pass
    elif rows_mode:
        x_post, P_post = _masked_update_rows(
            x_post, P_post, hp2, H_xv2, H_y2, z, h2, hi, cfg)
    else:
        x_post, P_post = _masked_update(
            x_post, P_post, H_xv2, H_y2, z, h2, hi, cfg, pht_all=pht_all2)

    return _step_core_epilogue(state, x_post, P_post, visible, ic,
                               li, hi, support, cfg)


def _step_core_epilogue(state, x_post, P_post, visible, ic, li, hi,
                        support, cfg: EngineConfig):
    """Shared tail of step_core_from_prior: NaN checks, state write,
    counter bookkeeping (update_features_info.m) and StepInfo."""
    if cfg.debug_nan_checks:
        from ekf_slam_tpu.utils.metrics import check_finite
        check_finite(x_post, "x_post", debug=True)
        check_finite(P_post, "P_post", debug=True)

    state = state.replace(x=x_post, P=P_post)

    # -- bookkeeping (stage 8 feature init is the caller's, it needs a
    # measurement source) ------------------------------------------------------
    measured = ic  # update_features_info.m: z non-empty ⇔ IC match stored
    state = mapman.update_counters(state, visible, measured)

    info = StepInfo(
        n_visible=jnp.sum(visible), n_ic=jnp.sum(ic),
        n_li=jnp.sum(li), n_hi=jnp.sum(hi), ransac_support=support)
    return state, visible, ic, info


@ekf.f32_matmuls
def step(state: FilterState, obs: FrameObs, key: jax.Array,
         cfg: EngineConfig):
    """One full SLAM frame on the sim path (ground-truth association).
    Returns (new_state, StepInfo)."""
    z, z_valid = gather_measurements(state, obs)
    state, visible, ic, info = step_core(state, z, z_valid, key, cfg)
    # -- 8. feature initialization from the current frame ----------------------
    if "init" not in _ABLATE:
        state = initialize_features(state, obs, jnp.sum(ic), cfg)
    return state, info


def _masked_update(x, P, H_xv, H_y, z, h, slot_mask, cfg: EngineConfig,
                   pht_all=None, return_factors=False):
    """EKF update over the masked slots. With max_update_obs = M > 0 the M
    most-relevant slots (inliers first) are GATHERED into a compact (2M, D)
    Jacobian — the solve shrinks from 2*CAP to 2M rows; identical result
    whenever the inlier count fits in M (tests/test_compact_update.py).

    pht_all: optional (D, 2·CAP) flat slot-major gain columns from
    measurement.pht_slots (same H blocks); saves the dense P@Hᵀ."""
    cap = slot_mask.shape[0]
    M = cfg.map.max_update_obs
    solver = cfg.filter.gain_solver
    if M <= 0 or M >= cap:
        H = measurement.dense_H(H_xv, H_y, slot_mask)
        return ekf.update(
            x, P, H, z.reshape(-1), h.reshape(-1), jnp.repeat(slot_mask, 2),
            jnp.ones(2 * cap, x.dtype), gain_solver=solver, PHt=pht_all,
            return_factors=return_factors)
    sel = jnp.argsort(~slot_mask)[:M]          # inlier slots first (stable)
    sel_mask = slot_mask[sel]
    H = measurement.compact_dense_H(H_xv[sel], H_y[sel], sel, sel_mask, cap)
    if pht_all is not None:
        cols = (2 * sel[:, None] + jnp.arange(2)).reshape(-1)
        PHt = pht_all[:, cols]                 # (D, 2M) column gather
    elif ekf._PHT_FORM == "rows":
        PHt = measurement.pht_compact_rows(P, H_xv[sel], H_y[sel], sel,
                                           sel_mask)
    else:
        PHt = None                              # dense P @ Hᵀ in update_gain
    return ekf.update(
        x, P, H, z[sel].reshape(-1), h[sel].reshape(-1),
        jnp.repeat(sel_mask, 2), jnp.ones(2 * M, x.dtype),
        gain_solver=solver, PHt=PHt,
        return_factors=return_factors)


def _masked_update_factors(x, P, H_xv, H_y, z, h, slot_mask,
                           cfg: EngineConfig, P4, corr=None):
    """Compact-M factor-only update phase for the deferred tail
    (EKF_DEFER). Mirrors _masked_update's top-M gather but returns
    (x_new, Ā, B̄) instead of applying the covariance correction.

    P4: rows 3:7 of the covariance this update acts on (compute dtype).
    corr: the LI phase's (Ā₁, B̄₁) — when given, P is the PRIOR and the
    posterior P·Hᵀ is computed in correction-adjusted form
    P·Hᵀ + Ā₁·(B̄₁ᵀ·Hᵀ) without materializing the posterior."""
    cap = slot_mask.shape[0]
    M = cfg.map.max_update_obs
    sel = jnp.argsort(~slot_mask)[:M]          # inlier slots first (stable)
    sel_mask = slot_mask[sel]
    H = measurement.compact_dense_H(H_xv[sel], H_y[sel], sel, sel_mask, cap)
    zc, hc = z[sel].reshape(-1), h[sel].reshape(-1)
    rm = jnp.repeat(sel_mask, 2)
    r = jnp.ones(2 * M, x.dtype)
    solver = cfg.filter.gain_solver
    if corr is None:
        return ekf.update_factors(x, P4, H, zc, hc, rm, r, solver, P=P)
    return ekf.update_factors(x, P4, H, zc, hc, rm, r, solver,
                              PHt=_pht_corrected(P, corr[0], corr[1], H))


@ekf.f32_matmuls
def _pht_corrected(P, A1, B1, H):
    """Posterior gain columns from the prior + LI factors:
    (P + Ā₁B̄₁ᵀ)·Hᵀ = P·Hᵀ + Ā₁·(B̄₁ᵀ·Hᵀ)."""
    Ht = H.T
    return ekf.p_compute(P) @ Ht + A1 @ (B1.T @ Ht)


@ekf.f32_matmuls
def _deferred_hi_blocks(top13, pyy1, A1, B1, cap):
    """Post-LI covariance blocks from the LI factors: the 13 camera rows
    and the (CAP, 6, 6) slot diagonals of P_prior + Ā₁B̄₁ᵀ — all of P
    the rescue gates' S needs, no posterior materialization. The slot
    increments contract the factors' landmark rows through a bitcast
    (CAP, 6, K) view — no gather."""
    cam = measurement.CAM_DIM
    top13_2 = top13 + A1[:cam] @ B1.T
    Ar = A1[cam:cam + 6 * cap].reshape(cap, 6, -1)
    Br = B1[cam:cam + 6 * cap].reshape(cap, 6, -1)
    pyy2 = pyy1 + jnp.einsum("cjk,clk->cjl", Ar, Br)
    return top13_2, pyy2


@ekf.f32_matmuls
def _apply_stacked_factors(P, A1, B1, A2, B2):
    """The deferred tail's single covariance apply:
    P_final = P + [Ā₁|Ā₂]·[B̄₁|B̄₂]ᵀ (one output write, one prior read)."""
    A = jnp.concatenate([A1, A2], axis=1)
    B = jnp.concatenate([B1, B2], axis=1)
    return ekf.p_store(ekf.p_compute(P) + A @ B.T, P)


def _masked_update_rows(x, P, hp, H_xv, H_y, z, h, slot_mask,
                        cfg: EngineConfig):
    """Row-form _masked_update (EKF_UPDATE=rows): the (2M, D) H·P operand
    is two contiguous row gathers of the split hp arrays (already
    computed from this phase's P — no extra P read) stacked in BLOCK
    order [u-rows; v-rows], matching compact_dense_H_block. Identical
    math to _masked_update whenever the inlier count fits in M (row
    permutation invariance; tests/test_layout_forms.py)."""
    hp_u, hp_v = hp
    cap = slot_mask.shape[0]
    M = cfg.map.max_update_obs
    if M <= 0 or M > cap:
        M = cap
    sel = jnp.argsort(~slot_mask)[:M]          # inlier slots first (stable)
    sel_mask = slot_mask[sel]
    Hc = measurement.compact_dense_H_block(
        H_xv[sel], H_y[sel], sel, sel_mask, cap)
    HP = jnp.concatenate([hp_u[sel], hp_v[sel]], axis=0)    # (2M, D)
    zb = jnp.concatenate([z[sel, 0], z[sel, 1]])
    hb = jnp.concatenate([h[sel, 0], h[sel, 1]])
    return ekf.update_rows(
        x, P, Hc, HP, zb, hb, jnp.tile(sel_mask, 2),
        jnp.ones(2 * M, x.dtype), cfg.filter.gain_solver)


def _masked_update_iterated(x, P, z, slot_mask, state: FilterState,
                            cfg: EngineConfig):
    """Gauss-Newton iterated LI update over the gathered inlier slots
    (ekf.update_iterated with a re-linearizing h_fn)."""
    cap = slot_mask.shape[0]
    M = cfg.map.max_update_obs
    if M <= 0 or M >= cap:
        sel = jnp.arange(cap)
    else:
        sel = jnp.argsort(~slot_mask)[:M]
    sel_mask = slot_mask[sel]

    def h_fn(xi):
        h_i, _, H_xv_i, H_y_i = _linearize(xi, P, state, cfg)[:4]
        H = measurement.compact_dense_H(
            H_xv_i[sel], H_y_i[sel], sel, sel_mask, cap)
        return h_i[sel].reshape(-1), H

    return ekf.update_iterated(
        x, P, z[sel].reshape(-1), h_fn, jnp.repeat(sel_mask, 2),
        jnp.ones(2 * sel.shape[0], x.dtype),
        num_iters=cfg.filter.iekf_iterations)


def _linearize(x, P, state: FilterState, cfg: EngineConfig):
    h, visible, hc = measurement.predict_measurements(
        x, state.active, state.cartesian, cfg)
    H_xv, H_y = measurement.jacobians(x, h, hc, state.cartesian, cfg.camera)
    return h, visible, H_xv, H_y, hc


@ekf.f32_matmuls
def bootstrap(state: FilterState, obs: FrameObs,
              cfg: EngineConfig) -> FilterState:
    """Initialize the map from the first frame (mono_slam.m runs
    map_management before the first prediction)."""
    return initialize_features(state, obs, jnp.asarray(0), cfg)


def run_sequence(state: FilterState, obs_seq: FrameObs, key: jax.Array,
                 cfg: EngineConfig):
    """lax.scan of `step` over a sequence. obs_seq fields carry a leading
    time axis. Returns (final_state, camera trajectory (T,13), StepInfo)."""
    T = obs_seq.pixels.shape[0]

    def body(st, inp):
        o, k = inp
        st, info = step(st, o, k, cfg)
        return st, (st.x[..., :13], info)

    keys = jax.random.split(key, T)
    final, (traj, infos) = jax.lax.scan(body, state, (obs_seq, keys))
    return final, traj, infos


# --- software-pipelined (staggered) batched driver --------------------------
#
# The per-frame stage chain (manage→predict→gates→RANSAC→LI→lin2→HI→init)
# is serial, and its small kernels only overlap within a stage. The
# staggered driver splits the batch into chains a phase out of step, so
# the elementwise-heavy gate phase (stages 1-4) of one chain is schedulable
# against the matmul/memory-heavy update phase (stages 5-8) of another.
# Whether this pays on the GPU is not measured yet. Per-instance math and the
# run_sequence key schedule are IDENTICAL (tests/test_engine.py pins
# bit-equality); only the program's instruction-level parallelism changes.

@pytree.dataclass
class Phase1Carry:
    """Everything stage 5 needs, produced by stages 1-4 of one frame.
    top13/pyy1 are the prior's S1 covariance blocks, carried only in the
    incremental rescue-block mode (EKF_S2FORM=inc; None otherwise)."""
    state: FilterState            # post-manage state
    x_prior: jnp.ndarray
    P_prior: jnp.ndarray
    z: jnp.ndarray
    h: jnp.ndarray
    H_xv: jnp.ndarray
    H_y: jnp.ndarray
    visible: jnp.ndarray
    ic: jnp.ndarray
    li: jnp.ndarray
    support: jnp.ndarray
    top13: jnp.ndarray = None
    pyy1: jnp.ndarray = None


def phase_split_supported(cfg: EngineConfig) -> bool:
    """The two-phase split covers the DEFAULT engine path only (cols
    update, no share_pht, no deferred tail, no iterated update, no
    ablation)."""
    return (not cfg.filter.share_pht
            and not cfg.filter.use_iterated_update
            and not _DEFER and not _ABLATE and not ekf._ABLATE
            and ekf._UPDATE != "rows")


def _phase_s2_inc(cfg: EngineConfig) -> bool:
    """EKF_S2FORM=inc applicability on the phase-split (default) path."""
    return (_S2FORM == "inc" and ekf._TAIL == "folded"
            and ekf._SYM == "stacked" and not ekf._TAIL16
            and measurement._S1FORM != "soa"
            and not _ABLATE and not ekf._ABLATE)


def gates_phase(state: FilterState, x_prior: jnp.ndarray,
                P_prior: jnp.ndarray, z: jnp.ndarray, z_valid: jnp.ndarray,
                key: jax.Array, cfg: EngineConfig) -> Phase1Carry:
    """Stages 3-4 (linearize, gates, RANSAC) given an already-managed
    state, its prediction and candidate measurements — the shared gate
    half of the sim (`step_phase1`) and image
    (vision/frontend.step_image_phase1) phase splits."""
    h, visible, H_xv, H_y = _linearize(x_prior, P_prior, state, cfg)[:4]
    vm = visible.astype(H_xv.dtype)[:, None, None]
    top13 = pyy1 = None
    if _phase_s2_inc(cfg):
        cap = state.capacity
        top13 = ekf.p_compute(P_prior[:measurement.CAM_DIM, :])
        pyy1 = measurement._slot_diag_blocks(ekf.p_compute(P_prior), cap)
        S = measurement.innovation_covariances_from_blocks(
            top13, pyy1, H_xv, H_y, cfg.filter.sigma_z)
    else:
        S = measurement.innovation_covariances(P_prior, H_xv, H_y,
                                               cfg.filter.sigma_z)
    ic = association.individually_compatible(z, z_valid, h, visible, S, cfg)
    li, support = ransac.run(
        x_prior, P_prior, z, h, H_xv * vm, H_y * vm, S, ic,
        state.cartesian, key, cfg)
    return Phase1Carry(state, x_prior, P_prior, z, h, H_xv, H_y,
                       visible, ic, li, support, top13, pyy1)


@ekf.f32_matmuls
def step_phase1(state: FilterState, obs: FrameObs, key: jax.Array,
                cfg: EngineConfig) -> Phase1Carry:
    """Stages 1-4 (gather, manage, predict, gates, RANSAC) of `step` —
    identical math, split for the staggered driver."""
    z, z_valid = gather_measurements(state, obs)
    state = mapman.manage(state, cfg)
    x_prior, P_prior = ekf.predict(state.x, state.P, cfg.filter)
    return gates_phase(state, x_prior, P_prior, z, z_valid, key, cfg)


def update_phase(c: Phase1Carry, cfg: EngineConfig):
    """Stages 5-7 + bookkeeping (LI update, rescue, HI update, counters)
    given a Phase1Carry. Returns (state, ic, StepInfo) — feature init is
    the caller's (it needs a measurement source: obs or image)."""
    if c.top13 is not None:
        x_post, P_post, (A1, B1) = _masked_update(
            c.x_prior, c.P_prior, c.H_xv, c.H_y, c.z, c.h, c.li, cfg,
            return_factors=True)
    else:
        x_post, P_post = _masked_update(
            c.x_prior, c.P_prior, c.H_xv, c.H_y, c.z, c.h, c.li, cfg)
    h2, vis2, H_xv2, H_y2 = _linearize(x_post, P_post, c.state, cfg)[:4]
    if c.top13 is not None:
        top13_2, pyy2 = _deferred_hi_blocks(
            c.top13, c.pyy1, A1, B1, c.state.capacity)
        S_noR = measurement.innovation_covariances_from_blocks(
            top13_2, pyy2, H_xv2, H_y2, 0.0)
    else:
        S_noR = measurement.innovation_covariances(P_post, H_xv2, H_y2, 0.0)
    hi = association.rescue_high_innovation(c.z, h2, S_noR, c.ic & vis2,
                                            c.li, cfg)
    x_post, P_post = _masked_update(
        x_post, P_post, H_xv2, H_y2, c.z, h2, hi, cfg)
    state, visible, ic, info = _step_core_epilogue(
        c.state, x_post, P_post, c.visible, c.ic, c.li, hi, c.support, cfg)
    return state, ic, info


@ekf.f32_matmuls
def step_phase2(c: Phase1Carry, obs: FrameObs, cfg: EngineConfig):
    """Stages 5-8 (LI update, rescue, HI update, bookkeeping, init) —
    the tail of `step` given a Phase1Carry. Returns (state, StepInfo)."""
    state, ic, info = update_phase(c, cfg)
    state = initialize_features(state, obs, jnp.sum(ic), cfg)
    return state, info


def staggered_chains_drive(states_list, p1, p2, frames, keys_list):
    """Generic k-chain software-pipelined sequence driver.

    The k chains are independent batch slices of one big batch, advanced
    through the SAME shared frame sequence with their phase boundaries
    interleaved in program order:

        p2(chain 0, t) ; p1(chain 1, t) ; p2(chain 1, t) ; ... ;
        p2(chain k-1, t) ; p1(chain 0, t+1)

    Every gate half (phase 1) is adjacent to another chain's update half
    (phase 2) with no data dependence between them, so XLA's scheduler
    can overlap their kernels. k=2 is the original two-half driver; the
    per-chain math is identical for any k (bit-pinned in
    tests/test_engine.py / tests/test_vision.py).

    states_list: k per-chain state pytrees. p1(state, frame, key) ->
    carry; p2(carry, frame) -> (state, out-pytree). frames: pytree with
    leading time axis T shared by all chains. keys_list: k arrays
    (T, ...) of per-frame keys. Returns (final_states_list, outs_list);
    outs_list[j] is chain j's out-pytree stacked over frames on axis 0.
    """
    k = len(states_list)
    T = jax.tree.leaves(frames)[0].shape[0]
    frame0 = jax.tree.map(lambda a: a[0], frames)
    c0 = p1(states_list[0], frame0, keys_list[0][0])

    def body(carry, xs):
        c0, rest = carry
        f_t, f_tp1, k0_tp1, krest_t = xs
        st0, out0 = p2(c0, f_t)
        outs = [out0]
        new_rest = []
        for j in range(k - 1):
            cj = p1(rest[j], f_t, krest_t[j])
            stj, outj = p2(cj, f_t)
            new_rest.append(stj)
            outs.append(outj)
        c0 = p1(st0, f_tp1, k0_tp1)
        return (c0, tuple(new_rest)), tuple(outs)

    xs = (jax.tree.map(lambda a: a[:T - 1], frames),
          jax.tree.map(lambda a: a[1:], frames),
          keys_list[0][1:],
          tuple(kl[:T - 1] for kl in keys_list[1:]))
    (c0, rest), scanned = jax.lax.scan(
        body, (c0, tuple(states_list[1:])), xs)

    # final frame: chain 0 completes T-1 (its phase1 ran in the last
    # body); chains 1..k-1 run frame T-1 whole.
    frame_last = jax.tree.map(lambda a: a[T - 1], frames)
    st0, out0 = p2(c0, frame_last)
    finals, lasts = [st0], [out0]
    for j in range(k - 1):
        cj = p1(rest[j], frame_last, keys_list[j + 1][T - 1])
        stj, outj = p2(cj, frame_last)
        finals.append(stj)
        lasts.append(outj)
    outs_list = [
        jax.tree.map(lambda s, l: jnp.concatenate([s, l[None]], axis=0),
                     scanned[j], lasts[j])
        for j in range(k)]
    return finals, outs_list


def _chain_slices(tree, chains: int, b: int):
    """Split the leading batch axis into `chains` equal slices."""
    return [jax.tree.map(lambda a, j=j: a[j * b:(j + 1) * b], tree)
            for j in range(chains)]


def run_sequence_staggered(states: FilterState, obs_seq: FrameObs,
                           keys: jax.Array, cfg: EngineConfig,
                           chains: int = 2):
    """Batched `run_sequence` with the batch split into `chains` slices
    a phase out of step (software pipelining — staggered_chains_drive).
    states: leading batch axis (B divisible by chains); keys: (B,) one
    per instance (split into per-frame keys exactly as run_sequence
    does). Returns (final_states, traj (B, T, 13), infos (B, T) fields)
    — the same values vmap(run_sequence) produces, in the same order.
    """
    if not phase_split_supported(cfg):
        raise ValueError("staggered driver requires the default engine "
                         "path (no rows/share_pht/defer/iterated/"
                         "ablate modes)")
    B = states.x.shape[0]
    assert B % chains == 0, "staggered driver needs B divisible by chains"
    b = B // chains
    T = obs_seq.pixels.shape[0]

    fkeys = jax.vmap(lambda k: jax.random.split(k, T))(keys)   # (B, T)
    keys_list = [jnp.swapaxes(fkeys[j * b:(j + 1) * b], 0, 1)  # (T, b)
                 for j in range(chains)]
    states_list = _chain_slices(states, chains, b)

    vp1 = jax.vmap(lambda st, o, k: step_phase1(st, o, k, cfg),
                   in_axes=(0, None, 0))
    vp2 = jax.vmap(lambda c, o: step_phase2(c, o, cfg), in_axes=(0, None))

    def p2(c, o):
        st, info = vp2(c, o)
        return st, (info, st.x[:, :13])

    finals, outs = staggered_chains_drive(states_list, vp1, p2,
                                          obs_seq, keys_list)

    def _assemble(stacked):
        # (T, b, ...) -> (b, T, ...)
        return jnp.swapaxes(stacked, 0, 1)

    traj = jnp.concatenate([_assemble(o[1]) for o in outs], axis=0)
    infos = jax.tree.map(
        lambda *parts: jnp.concatenate([_assemble(p) for p in parts],
                                       axis=0),
        *[o[0] for o in outs])
    final = jax.tree.map(lambda *parts: jnp.concatenate(parts, axis=0),
                         *finals)
    return final, traj, infos
