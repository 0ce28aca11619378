"""EKF predict / update over the padded state (L2).

predict: exploits the block-sparse structure of F (only the 13-dim camera
block is non-identity, predict_state_and_covariance.m:26-27) — the map block
of P is copied, the camera rows/cols get one (13,D) matmul each.

update: masked dense update. The reference stacks only the inlier rows
(ekf_update_li_inliers.m:8-16) and inverts S explicitly (update.m:8-9);
here every one of the 2*CAP candidate rows is always present, with inactive
rows zeroed in H and the residual and given unit measurement noise, which
makes S carry an identity block there — the Kalman gain columns for those
rows are then exactly zero, so the result equals the reference's compact
update (tests/test_ekf.py::test_masked_update_equals_compact_oracle). The
gain solve uses Cholesky (S is SPD by construction) instead of inv(S) —
numerically equivalent for these well-conditioned S and matmul-friendly.

Both quaternion renormalization steps follow update.m:18-24: x_q /= |x_q|
and the covariance is mapped through the normalization Jacobian (normJac).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ekf_slam_tpu.config import CAM_DIM, FilterConfig
from ekf_slam_tpu.filter import motion
from ekf_slam_tpu.ops import quaternion as quat


import os

# Matmul precision for everything covariance-touching. "float32" (true
# f32 matmuls) is the verified-safe default; "tensorfloat32" lets the GPU
# run the covariance products on TF32 tensor cores (10-bit mantissa). The
# choice is gated by the accuracy bands of bench.py and chip_smoke.py's
# precision phase.
_COV_PRECISION = os.environ.get("EKF_COV_PRECISION", "float32")

# A/B knob for the stripe-vs-full-pass P write-backs (mathematically
# identical forms, different lowerings): "all" = stripe predict/manage
# AND gather-blend feature-add, "mgmt" = stripe predict/manage only,
# "pred" = STATIC-offset predict stripes only (no per-instance offsets,
# so no vmap scatter serialization), "none" = round-1 concat/low-rank
# full-pass forms. "pred" is the default: static stripes touch 26/613
# rows where the concat form can materialize the full P. Which form is
# fastest on the GPU is not measured yet.
_STRIPES = os.environ.get("EKF_STRIPES", "pred")

# Trace-time override of the stripe form (parallel/sharded_filter.py
# traces its tensor-parallel step with "predT": the "pred" form's second
# DUS writes rows 13:D of a row-SHARDED P — a partial-shard update GSPMD
# implements as a full-P all-gather + per-shard reslice; "predT" writes
# the (D, 13) column stripe at offset (0,0) instead, which covers the
# whole sharded dim and partitions trivially). Bit-identical outputs.
_STRIPES_OVERRIDE = [None]


class stripes_override:
    """Context manager: pin the predict stripe form while TRACING a
    program (the form is a trace-time choice; nesting restores)."""

    def __init__(self, form):
        self.form = form

    def __enter__(self):
        self.prev = _STRIPES_OVERRIDE[0]
        _STRIPES_OVERRIDE[0] = self.form

    def __exit__(self, *exc):
        _STRIPES_OVERRIDE[0] = self.prev


# Trace-time covariance sharding annotation (parallel/sharded_filter.py):
# a function applied to every freshly materialized full P. Without it,
# GSPMD's propagation pass sees predict's many small row-slice consumers
# (S assembly reads P[:13], P[3:7], per-slot stripes) and votes the
# post-predict P REPLICATED — a full-P all-gather per frame. Pinning the
# producer keeps P row-sharded end to end; the small row reads then pay
# O(13*D) transfers instead. No-op when unset (single-device paths).
_P_ANNOTATE = [None]


def annotate_p(P: jnp.ndarray) -> jnp.ndarray:
    f = _P_ANNOTATE[0]
    return f(P) if f is not None else P


class p_annotate:
    """Context manager installing the covariance sharding annotation
    while tracing a program."""

    def __init__(self, fn):
        self.fn = fn

    def __enter__(self):
        self.prev = _P_ANNOTATE[0]
        _P_ANNOTATE[0] = self.fn

    def __exit__(self, *exc):
        _P_ANNOTATE[0] = self.prev

# Compact-update P·Hᵀ form: "rows" computes (Hc P)ᵀ from a 13-cam-row +
# M-slot-stripe row gather of the SYMMETRIC P, "dense" does the full
# P @ Hcᵀ dot (the default); "rows" kept for A/B.
_PHT_FORM = os.environ.get("EKF_PHT", "dense")

# Covariance-downdate symmetrization form: "transpose" = materialize
# 0.5(P−KPHtᵀ) then add its transpose (exactly symmetric; pays a full-P
# layout copy), "stacked" = one [K|PHt]·[PHt|K]ᵀ dot (symmetric to ~1 ulp,
# no transpose copy) — the default; f64 end-to-end A/B agrees to 1.5e-15.
_SYM = os.environ.get("EKF_SYM", "stacked")

# Covariance-tail form: "folded" folds the quaternion-renorm transform
# T = I ⊕ J4 into the SAME rank-(2M+8) downdate dot (P⁺ = P + Ā·B̄ᵀ, one
# full-P read + one write, no post-hoc stripe rewrites of P), "split"
# runs the stacked downdate dot then the renorm stripe adds as separate
# full-P passes. Mathematically identical (test_layout_forms pins the
# fold to the dense T·M·Tᵀ).
_TAIL = os.environ.get("EKF_TAIL", "folded")

# Update operand layout: "rows" routes the engine through
# update_rows/pht_rows_split — ONE shared row-form H·P read per update
# phase feeds the S gates, RANSAC and the update, and nothing
# materializes a (D, k) tall-skinny or a full-P transpose. "cols" is the
# column-form path.
#
# DEFAULT cols: the rows tail once accumulated covariance asymmetry
# geometrically under reduced-precision matmuls (no producer
# re-symmetrizes P in rows form) until hᵀPh went negative at ~frame 7
# (tools/probe_rows_nan.py); update_rows now applies its correction in a
# symmetric-by-expression form (see there).
_UPDATE = os.environ.get("EKF_UPDATE", "cols")

# EKF_TAIL16=1: run the folded correction dot as a single DEFAULT-
# precision bf16 pass when P is STORED bf16 (fast mode only; A/B knob,
# accuracy-gated by bench.py).
_TAIL16 = os.environ.get("EKF_TAIL16", "0") == "1"

# Attribution-only sub-update ablation tokens (share the EKF_ABLATE env
# list with engine.py's stage tokens, so update internals are ablatable
# through the bench harness): "pht" zeroes the P·Hᵀ
# product (skips its P read), "gain" skips the S⁻¹ solve (W = I),
# "tail" skips the whole covariance write-back, "renorm" skips the
# quaternion-renorm covariance correction. bench.py waives its accuracy
# gates when any token is set; never set in production.
_ABLATE = frozenset(
    s for s in os.environ.get("EKF_ABLATE", "").split(",") if s)


def p_compute(P: jnp.ndarray) -> jnp.ndarray:
    """Storage -> compute view of the covariance: a bfloat16-stored P
    (FilterConfig.p_storage='bf16') upcasts to float32 for all algebra;
    the convert fuses into the consuming matmul/elementwise read, so the
    HBM read stays half-width. No-op for f32/f64 storage."""
    return P.astype(jnp.float32) if P.dtype == jnp.bfloat16 else P


def p_store(P_new: jnp.ndarray, P_like: jnp.ndarray) -> jnp.ndarray:
    """Compute -> storage: downcast a freshly-materialized covariance to
    the carried storage dtype (fuses into the producing write). Pair of
    p_compute. bf16 storage halves every full-P HBM materialization; the
    cost is ~0.4% relative rounding per write — the fast mode is gated by
    config and excluded from the golden-equivalence paths."""
    return (P_new.astype(P_like.dtype)
            if P_like.dtype == jnp.bfloat16 else P_new)


def f32_matmuls(fn):
    """Run `fn` with its matmuls at the EKF_COV_PRECISION setting
    (float32-accurate by default).

    Default-precision float32 matmuls run in reduced precision on the GPU
    (TF32 tensor cores, 10-bit mantissa); covariance algebra cannot
    survive that (the first update with fresh sigma_rho = 1 features makes
    S lose SPD-ness and the Cholesky NaNs), and the f32 parity mode must
    track the float64 oracle. The per-frame entry points (engine.step,
    engine.bootstrap, the phase-split steps, frontend.step_image) run
    entirely under it, and every covariance-touching function is wrapped
    too for direct callers. Explicit per-op precisions (the Newton-Schulz
    fast phase, the NCC convolutions) are kept. float64 paths are
    unaffected by the setting."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision(_COV_PRECISION):
            return fn(*args, **kwargs)
    return wrapped


@f32_matmuls
def predict(x: jnp.ndarray, P: jnp.ndarray, cfg: FilterConfig):
    """EKF time update (predict_state_and_covariance.m:1-27).

    x: (D,), P: (D,D). Returns (x_pred, P_pred).
    """
    xv = x[:CAM_DIM]
    x_pred = jnp.concatenate([motion.fv(xv, cfg), x[CAM_DIM:]])

    F = motion.dfv_by_dxv(xv, cfg)
    Q = motion.process_noise(xv, cfg)

    # P⁻ = [F P₁₁ Fᵀ + Q , F P₁ₘ ; Pₘ₁ Fᵀ , Pₘₘ]: only 13 rows + 13 cols
    # of P change, so write them as dynamic_update_slice STRIPES into the
    # (dead) input buffer. The concat assembly can lower to full-P pad+add
    # materializations; this form touches 26/613 of the matrix.
    top = F @ p_compute(P[:CAM_DIM, :])            # (13, D): 13-row read
    top = jnp.concatenate(
        [top[:, :CAM_DIM] @ F.T + Q, top[:, CAM_DIM:]], axis=1)
    stripes = _STRIPES_OVERRIDE[0] or _STRIPES
    if stripes == "predsel":
        # Fully elementwise stripe write (the tensor-parallel form,
        # parallel/sharded_filter.py): mask-select the 13 camera rows and
        # columns from a zero-padded `top` instead of dynamic-update-
        # slicing them in. A sub-shard DUS on an UNEVENLY tiled sharded
        # dim (D odd over k shards) falls back to a full-P all-gather in
        # GSPMD; where-selects partition trivially. Values BIT-identical
        # to "pred" (exact selection; tests/test_layout_forms.py).
        # Costs two full-P elementwise passes — TP-only, not the
        # single-device default.
        sdt = P.dtype
        D = P.shape[0]
        cm = jnp.arange(D) < CAM_DIM
        topT_full = jnp.pad(top.T.astype(sdt), ((0, 0), (0, D - CAM_DIM)))
        top_full = jnp.pad(top.astype(sdt), ((0, D - CAM_DIM), (0, 0)))
        P_pred = jnp.where(cm[None, :], topT_full, P)
        P_pred = jnp.where(cm[:, None], top_full, P_pred)
        return x_pred, annotate_p(P_pred)
    if stripes == "predT":
        # Same two stripes, written column-stripe-first and both at
        # offset (0, 0): the (D, 13) column write spans the FULL row dim
        # (partitionable when P's rows are sharded over a mesh — see
        # _STRIPES_OVERRIDE) and the (13, D) row write then overwrites
        # the 13x13 corner with the same values the "pred" form puts
        # there. Final P is BIT-identical to "pred"
        # (tests/test_layout_forms.py pins it).
        sdt = P.dtype
        P_pred = jax.lax.dynamic_update_slice(P, top.T.astype(sdt), (0, 0))
        P_pred = jax.lax.dynamic_update_slice(
            P_pred, top.astype(sdt), (0, 0))
        return x_pred, annotate_p(P_pred)
    if stripes not in ("pred", "mgmt", "all"):
        Pf = p_compute(P)
        bottom = jnp.concatenate(
            [top[:, CAM_DIM:].T, Pf[CAM_DIM:, CAM_DIM:]], axis=1)
        return x_pred, annotate_p(p_store(
            jnp.concatenate([top, bottom], axis=0), P))
    sdt = P.dtype
    P_pred = jax.lax.dynamic_update_slice(P, top.astype(sdt), (0, 0))
    P_pred = jax.lax.dynamic_update_slice(
        P_pred, top[:, CAM_DIM:].T.astype(sdt), (CAM_DIM, 0))
    return x_pred, annotate_p(P_pred)


@f32_matmuls
def update_gain(x: jnp.ndarray, P: jnp.ndarray, H: jnp.ndarray,
                z: jnp.ndarray, h: jnp.ndarray, row_mask: jnp.ndarray,
                r_diag: jnp.ndarray, gain_solver: str = "cholesky",
                PHt: jnp.ndarray = None):
    """The gain/state half of the masked EKF update (update.m:8-11):
    everything except the covariance tail. Returns
    (x_new (un-renormalized), K (D, M), PHt_masked (D, M)) so a caller can
    run the covariance tail separately (update_factors)."""
    dtype = x.dtype
    mask = row_mask.astype(dtype)
    H = H * mask[:, None]
    nu = (z - h) * mask
    r_eff = jnp.where(row_mask, r_diag, jnp.ones_like(r_diag))
    if "pht" in _ABLATE:
        PHt = jnp.zeros((P.shape[0], H.shape[0]), dtype)
    elif PHt is None and _PHT_FORM == "mixed16" and P.dtype == jnp.bfloat16:
        # bf16-stored P: ONE single-pass bf16 dot against the
        # two-term bf16 split of H (hi + lo capture ~16 mantissa bits;
        # residual ~2^-16 relative, far below the 2^-8 storage rounding
        # of P itself). The f32-emulated alternative upcasts P and pays
        # 3 passes, one of which multiplies the upcast's ZERO lo-split.
        # WARNING: unit-pinned on CPU but went NON-FINITE in the real
        # engine on an accelerator — do NOT enable in production; kept for
        # numerics investigation only.
        Hh = H.astype(jnp.bfloat16)
        Hl = (H - Hh.astype(jnp.float32)).astype(jnp.bfloat16)
        Hcat = jnp.concatenate([Hh, Hl], axis=0)           # (2M', D)
        both = jax.lax.dot_general(
            P, Hcat.T, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.DEFAULT,
            preferred_element_type=jnp.float32)            # (D, 2M')
        M_ = H.shape[0]
        PHt = both[:, :M_] + both[:, M_:]
    elif PHt is None:
        PHt = p_compute(P) @ H.T               # (D, M)
    else:
        PHt = PHt * mask[None, :]
    S = H @ PHt + jnp.diag(r_eff)              # (M, M), SPD
    if "gain" in _ABLATE:
        W = jnp.eye(S.shape[-1], dtype=dtype)
    else:
        W = (_spd_inverse_newton(S) if gain_solver == "newton"
             else _spd_inverse(S))
    K = PHt @ W                                # (D, M)
    return x + K @ nu, K, PHt


@f32_matmuls
def _folded_tail_factors(x_new: jnp.ndarray, P4: jnp.ndarray,
                         K: jnp.ndarray, PHt: jnp.ndarray):
    """Factors (Ā, B̄) of the folded covariance tail P⁺ = P + Ā·B̄ᵀ — the
    symmetric downdate AND quaternion-renorm fold as one rank-(2M+8)
    correction (see `update`'s folded branch for the algebra). P4: rows
    3:7 of the covariance this update acts on, in COMPUTE dtype — the
    identity holds for any symmetric P, which is what lets the deferred
    two-update path (`update_factors`) feed correction-adjusted rows
    instead of materialized-P rows. Returns (x renormalized, Ā, B̄)."""
    dtype = x_new.dtype
    D = P4.shape[1]
    A = jnp.concatenate([K, PHt], axis=1)                  # (D, 2M')
    B = jnp.concatenate([PHt, K], axis=1)
    q = x_new[3:7]
    G = quat.norm_jac(q) - jnp.eye(4, dtype=dtype)
    M4 = P4 - 0.5 * (A[3:7, :] @ B.T)                      # (4, D)
    M44 = M4[:, 3:7]
    W = M4.T @ G.T                                         # (D, 4)
    E4 = jnp.zeros((D, 4), dtype).at[3:7, :].set(
        jnp.eye(4, dtype=dtype))
    A_f = jnp.concatenate(
        [-0.5 * A, E4, W + E4 @ (G @ M44 @ G.T)], axis=1)
    B_f = jnp.concatenate([B, W, E4], axis=1)
    x_new = x_new.at[3:7].set(q / jnp.linalg.norm(q))
    return x_new, A_f, B_f


@f32_matmuls
def update_factors(x: jnp.ndarray, P4: jnp.ndarray, H: jnp.ndarray,
                   z: jnp.ndarray, h: jnp.ndarray, row_mask: jnp.ndarray,
                   r_diag: jnp.ndarray, gain_solver: str = "cholesky",
                   PHt: jnp.ndarray = None, P: jnp.ndarray = None):
    """Deferred-tail update phase (engine EKF_DEFER mode): gain + state
    update + folded-tail factor construction WITHOUT applying the
    covariance correction. The engine stacks both updates' factors and
    applies P_final = P_prior + [Ā₁|Ā₂]·[B̄₁|B̄₂]ᵀ as ONE full-P
    correction dot — one output write and one prior read instead of two
    of each (update.m:13-24 applied twice, algebraically identical).

    P4: rows 3:7 of the covariance this update acts on (phase 2 passes
    the correction-adjusted rows, NOT rows of a materialized P_post).
    Exactly one of P (phase 1: dense P·Hᵀ computed here) or PHt
    (phase 2: correction-adjusted, caller-computed) must be given.
    Returns (x_new renormalized, Ā, B̄)."""
    x_new, K, PHt = update_gain(x, P, H, z, h, row_mask, r_diag,
                                gain_solver, PHt)
    return _folded_tail_factors(x_new, P4, K, PHt)


@f32_matmuls
def update(x: jnp.ndarray, P: jnp.ndarray, H: jnp.ndarray, z: jnp.ndarray,
           h: jnp.ndarray, row_mask: jnp.ndarray, r_diag: jnp.ndarray,
           gain_solver: str = "cholesky", PHt: jnp.ndarray = None,
           return_factors: bool = False):
    """Masked EKF measurement update (update.m:1-32).

    H: (M, D) dense Jacobian, rows for unused measurements MUST be zero.
    z, h: (M,) stacked measurements/predictions. row_mask: (M,) bool.
    r_diag: (M,) measurement noise variances for active rows.

    Returns (x_new, P_new); with return_factors=True (plain-XLA folded
    stacked tail only), (x_new, P_new, (Ā, B̄)) — the rank-(2M+8) factors
    with P_new = P + Ā·B̄ᵀ, so callers can DOWNDATE small covariance
    blocks (the engine's incremental S₂ form, EKF_S2FORM=inc) instead of
    re-extracting them from the materialized posterior.
    """
    # PHt may be precomputed by the caller from H's block structure
    # (measurement.pht_slots). The caller
    # must have applied the SAME row mask to it. W = S⁻¹ via Cholesky or
    # Newton-Schulz (the reference uses a plain inv(S), update.m:9);
    # materializing the M×M inverse keeps the sequential triangular work at
    # O(M³) and turns the D-sized work into pure matmuls.
    x_new, K, PHt = update_gain(
        x, P, H, z, h, row_mask, r_diag, gain_solver, PHt)
    if "tail" in _ABLATE:
        if return_factors:
            raise ValueError("return_factors is incompatible with the "
                             "tail ablation")
        x_new = x_new.at[3:7].set(
            x_new[3:7] / jnp.linalg.norm(x_new[3:7]))
        return x_new, P
    # P ← P − K S Kᵀ = P − K (P Hᵀ)ᵀ, then symmetrize (update.m:13-14) and
    # quaternion renorm (update.m:18-24). The whole covariance tail is
    # memory-bound.
    if _TAIL == "folded" and _SYM == "stacked" and "renorm" not in _ABLATE:
        # The ENTIRE covariance tail — symmetric downdate AND quaternion-
        # renorm covariance correction (update.m:13-24) — as ONE
        # rank-(2M+8) correction dot over P:
        #
        #   P⁺ = T·(P − ½ABᵀ)·Tᵀ with T = I + C, C = E₄·G·E₄ᵀ,
        #        G = normJac(q) − I₄, E₄ = one-hot rows 3:7
        #      = P + Ā·B̄ᵀ
        #   Ā = [−½A | E₄ | W + E₄·(G·M₄₄·Gᵀ)],  B̄ = [B | W | E₄]
        #   M₄ = rows 3:7 of M = P₄ − ½A₄Bᵀ (4,D);  M₄₄ = M₄[:,3:7];
        #   W = M₄ᵀGᵀ (D,4)
        #
        # using M = Mᵀ (P enters symmetric, ABᵀ symmetric). The split
        # form pays the downdate write PLUS renorm stripe rewrites of the
        # full matrix; this form touches P once each way, with the add
        # and storage cast fusing into the dot's consumer.
        x_new, A_f, B_f = _folded_tail_factors(
            x_new, p_compute(P[3:7, :]), K, PHt)
        if _TAIL16 and P.dtype == jnp.bfloat16:
            # bf16 fast mode only: the correction dot as ONE DEFAULT-
            # precision bf16 pass (vs a tensorfloat32 one). The
            # factor rounding injects ~2^-8 relative error of the
            # CORRECTION — the same order as the bf16 store rounding of
            # P itself, so fast-mode accuracy gates still bind.
            corr = jax.lax.dot_general(
                A_f.astype(jnp.bfloat16), B_f.astype(jnp.bfloat16).T,
                (((1,), (0,)), ((), ())),
                precision=jax.lax.Precision.DEFAULT,
                preferred_element_type=jnp.float32)
            P_new = p_compute(P) + corr
        else:
            P_new = p_compute(P) + A_f @ B_f.T
        if return_factors:
            return x_new, p_store(P_new, P), (A_f, B_f)
        return x_new, p_store(P_new, P)
    if return_factors:
        raise ValueError("return_factors requires the folded stacked "
                         "tail (EKF_TAIL=folded, EKF_SYM=stacked, no "
                         "tail/renorm ablation)")
    if _SYM == "stacked":
        # Symmetric downdate as ONE stacked dot: K·PHtᵀ + PHt·Kᵀ =
        # [K|PHt]·[PHt|K]ᵀ — no full-P transpose (which pays a full-P
        # layout copy) and symmetric to ~1 ulp.
        # P enters symmetric (every producer ensures it), so the old
        # form's 0.5(P+Pᵀ) re-symmetrization of P itself is a no-op.
        A = jnp.concatenate([K, PHt], axis=1)              # (D, 2M')
        B = jnp.concatenate([PHt, K], axis=1)
        P_new = p_compute(P) - 0.5 * (A @ B.T)
    else:
        P_new = 0.5 * (p_compute(P) - K @ PHt.T)
        P_new = P_new + P_new.T
    if "renorm" in _ABLATE:
        x_new = x_new.at[3:7].set(
            x_new[3:7] / jnp.linalg.norm(x_new[3:7]))
    else:
        x_new, P_new = _renormalize_quaternion(x_new, P_new)
    return x_new, p_store(P_new, P)


@f32_matmuls
def update_rows(x: jnp.ndarray, P: jnp.ndarray, H: jnp.ndarray,
                HP: jnp.ndarray, z: jnp.ndarray, h: jnp.ndarray,
                row_mask: jnp.ndarray, r_diag: jnp.ndarray,
                gain_solver: str = "cholesky"):
    """Masked EKF update in ROW form — the row-operand twin of `update`
    (update.m:1-32, identical math; tests/test_layout_forms.py pins f64
    agreement to 1e-10).

    H (2M, D): dense measurement rows (any row order — the update is
    permutation invariant; engine uses block order u-rows;v-rows).
    HP (2M, D): H·P rows (= (P·Hᵀ)ᵀ by symmetry of P), typically gathered
    from measurement.pht_rows_split — the caller's ONE full-P product
    read per update.

    Why rows: every operand stays (rows, D) with the big dim minor —
    S = HP·Hᵀ and the correction factors contract over ROWS, so nothing
    materializes a tall-skinny (D, k) array (k = 2M/192/200 all tile-pad)
    and no [K|PHt]-style width-2M concats or full-P transposes exist.
    The Kalman gain K = PHtS⁻¹ is never materialized: the state moves by
    (HP)ᵀ·(W·ν) and the covariance by the symmetric rank-2M downdate
    −(HP)ᵀ·½(W+Wᵀ)·HP, folded with the quaternion-renorm correction into
    ONE rank-(2M+8) dot against P (the EKF_TAIL=folded scheme of
    `update`, re-derived for row operands)."""
    dtype = x.dtype
    mask = row_mask.astype(dtype)
    H = H * mask[:, None]
    HP = (jnp.zeros_like(HP) if "pht" in _ABLATE
          else HP * mask[:, None])
    nu = (z - h) * mask
    r_eff = jnp.where(row_mask, r_diag, jnp.ones_like(r_diag))
    S = jax.lax.dot_general(
        HP, H, (((1,), (1,)), ((), ()))) + jnp.diag(r_eff)   # (2M, 2M)
    if "gain" in _ABLATE:
        W = jnp.eye(S.shape[-1], dtype=dtype)
    else:
        W = (_spd_inverse_newton(S) if gain_solver == "newton"
             else _spd_inverse(S))
    x_new = x + jnp.einsum("md,m->d", HP, W @ nu)
    if "tail" in _ABLATE:
        if return_factors:
            raise ValueError("return_factors is incompatible with the "
                             "tail ablation")
        x_new = x_new.at[3:7].set(
            x_new[3:7] / jnp.linalg.norm(x_new[3:7]))
        return x_new, P
    Wbar = 0.5 * (W + W.T)
    N = Wbar @ HP                                            # (2M, D)
    q = x_new[3:7]
    if "renorm" in _ABLATE:
        corr = jax.lax.dot_general(HP, N, (((0,), (0,)), ((), ())))
        P_new = p_compute(P) - corr
        x_new = x_new.at[3:7].set(q / jnp.linalg.norm(q))
        return x_new, p_store(P_new, P)
    # Folded tail, row operands: P⁺ = T(P − (HP)ᵀN)Tᵀ = P + ĀᵀᵀB̄ᵀ with
    # Āᵀ = [−N ; E₄ᵀ ; G·M₄ + (G·M₄₄·Gᵀ)·E₄ᵀ], B̄ᵀ = [HP ; G·M₄ ; E₄ᵀ],
    # M₄ = rows 3:7 of P − (HP)ᵀN, G = normJac(q) − I₄ (see `update`).
    D = P.shape[0]
    G = quat.norm_jac(q) - jnp.eye(4, dtype=dtype)
    corr4 = -jax.lax.dot_general(
        HP[:, 3:7], N, (((0,), (0,)), ((), ())))             # (4, D)
    M4 = p_compute(P[3:7, :]) + corr4
    M44 = M4[:, 3:7]
    W2T = G @ M4                                             # (4, D)
    E4T = jnp.zeros((4, D), dtype).at[:, 3:7].set(
        jnp.eye(4, dtype=dtype))
    At = jnp.concatenate(
        [-N, E4T, W2T + (G @ M44 @ G.T) @ E4T], axis=0)      # (2M+8, D)
    Bt = jnp.concatenate([HP, W2T, E4T], axis=0)
    x_new = x_new.at[3:7].set(q / jnp.linalg.norm(q))
    # Correction as the SYMMETRIC-BY-EXPRESSION stacked dot
    # ½(AtᵀBt + BtᵀAt) = [At;Bt]ᵀ·½[Bt;At]: equal to AtᵀBt in exact
    # arithmetic (the fold is symmetric when P enters symmetric), but its
    # floating-point asymmetry is pure dot rounding (~1e-6·|corr|),
    # INDEPENDENT of the factors' own rounding. The plain AtᵀBt form
    # carries −NᵀHP whose asymmetry scales with fl(Wbar·HP)'s error ×
    # |HP| — on-device that seed compounds geometrically through the
    # S → W → corr feedback until P goes indefinite at ~frame 7
    # (tools/probe_rows_nan.py). With the symmetric expression the
    # asymmetry has NO feedback term (corr is symmetric for ANY operand
    # values) and grows only linearly at ulp scale.
    G1 = jnp.concatenate([At, Bt], axis=0)                   # (2R, D)
    G2 = jnp.concatenate([Bt, At], axis=0)
    P_new = p_compute(P) + 0.5 * jax.lax.dot_general(
        G1, G2, (((0,), (0,)), ((), ())))
    return x_new, p_store(P_new, P)


def _spd_inverse(S: jnp.ndarray) -> jnp.ndarray:
    """SPD inverse via Cholesky: S⁻¹ = L⁻ᵀ L⁻¹."""
    chol = jax.lax.linalg.cholesky(S)
    eye = jnp.eye(S.shape[-1], dtype=S.dtype)
    Linv = jax.scipy.linalg.solve_triangular(chol, eye, lower=True)
    return Linv.T @ Linv


_NEWTON_ITERS = int(os.environ.get("EKF_NEWTON_ITERS", "20"))
_NEWTON_MODE = os.environ.get("EKF_NEWTON_MODE", "fixed")


def _spd_inverse_newton(S: jnp.ndarray, iters: int = _NEWTON_ITERS,
                        refine_iters: int = 3) -> jnp.ndarray:
    """SPD inverse by Newton-Schulz iteration X ← X(2I − SX) — pure
    matmuls instead of the sequential Cholesky/triangular solves (batched
    small triangular solves are latency-bound; tools/profile_linalg.py).

    Valid here because the engine's S = H P Hᵀ + R has eigenvalues ≥ min(R)
    (R = I on the inlier updates), so X₀ = I/λ_up with the Gershgorin upper
    bound λ_up ≥ λ_max gives ‖I − S X₀‖ < 1 and quadratic convergence;
    `iters` = 20 covers condition numbers up to ~1e5 at float32 accuracy.

    Mixed precision: the iteration is SELF-CORRECTING (each step is a
    Newton step on the residual I − SX), so the first iters−refine_iters
    run at the backend's fast default matmul precision (TF32 tensor cores
    on the GPU) and only the last `refine_iters` run at f32-accurate
    precision — classic iterative refinement: the fast phase lands X at
    ~1e-3 relative error and each f32 step squares the residual
    (1e-3 → 1e-6 → float32 floor). On f64 inputs precision settings are
    no-ops and the result is the plain 20-iteration Newton inverse."""
    M = S.shape[-1]
    eye = jnp.eye(M, dtype=S.dtype)
    # Jacobi-preconditioned start: X₀ = D⁻¹/λ̂ with D = diag(S) and λ̂ the
    # Gershgorin bound of D^-1/2 S D^-1/2. S X₀ is similar to Ŝ/λ̂ whose
    # spectrum lies in (0,1], so convergence holds as before but the
    # initial residual no longer depends on S's raw diagonal spread
    # (innovation covariances mix σ²≈1 pixel rows with large fresh-slot
    # variances) — strictly tighter than the unpreconditioned Gershgorin
    # start at the same iteration count.
    d = jnp.diagonal(S, axis1=-2, axis2=-1)
    d = jnp.where(d > 0, d, jnp.ones_like(d))
    rsd = jax.lax.rsqrt(d)
    S_hat_rows = jnp.sum(jnp.abs(S) * rsd[..., :, None] * rsd[..., None, :],
                         axis=-1)
    lam_up = jnp.max(S_hat_rows, axis=-1)
    X = (eye / d[..., None, :]) / lam_up[..., None, None]
    fast = jax.lax.Precision.DEFAULT
    accurate = jax.lax.Precision.HIGHEST

    def body_fast(_, X):
        SX = jnp.matmul(S, X, precision=fast)
        return jnp.matmul(X, 2.0 * eye - SX, precision=fast)

    def body_accurate(_, X):
        SX = jnp.matmul(S, X, precision=accurate)
        return jnp.matmul(X, 2.0 * eye - SX, precision=accurate)

    if _NEWTON_MODE == "adaptive":
        # Early-exit while_loop: stop the fast phase once the residual
        # ‖I − SX‖_max is below bf16 resolution (the refine phase then
        # polishes to f32). The iteration is lock-step across a vmapped
        # batch — the worst-conditioned instance bounds the count — but
        # steady-state S (tracked features, Jacobi-preconditioned start)
        # converges in ~6-10 iterations vs the fixed 17+3. A/B via
        # EKF_NEWTON_MODE.
        def cond(state):
            i, X, res = state
            return (i < max(iters - refine_iters, 0)) & (res > 5e-3)

        def body(state):
            i, X, _ = state
            SX = jnp.matmul(S, X, precision=fast)
            X = jnp.matmul(X, 2.0 * eye - SX, precision=fast)
            res = jnp.max(jnp.abs(SX - eye))
            return i + 1, X, res

        _, X, _ = jax.lax.while_loop(
            cond, body, (0, X, jnp.asarray(1.0, S.dtype)))
    else:
        X = jax.lax.fori_loop(0, max(iters - refine_iters, 0),
                              body_fast, X)
    return jax.lax.fori_loop(0, refine_iters, body_accurate, X)


def _renormalize_quaternion(x: jnp.ndarray, P: jnp.ndarray):
    """q ← q/|q| with covariance correction P ← T P Tᵀ, T = I except the
    4x4 normJac block on the quaternion rows/cols (update.m:18-24).

    Written as T = I + Δ (Δ = normJac − I on the quaternion rows): two
    STATIC-offset stripe adds touch only 4 rows + 4 cols of P. The
    previous concat-based row/col replacement lowered every concatenate
    to full-P pad+maximum chains (full-P materializations per concat,
    ×2 concats ×2 updates per frame). Same math up to float reassociation:
    J·P[3:7] = P[3:7] + (J−I)·P[3:7]."""
    J = quat.norm_jac(x[3:7])
    D4 = J - jnp.eye(4, dtype=P.dtype)
    P = P.at[3:7, :].add(D4 @ P[3:7, :])       # rows: T P
    P = P.at[:, 3:7].add(P[:, 3:7] @ D4.T)     # cols: (T P) Tᵀ
    x = x.at[3:7].set(x[3:7] / jnp.linalg.norm(x[3:7]))
    return x, P


@f32_matmuls
def update_iterated(x: jnp.ndarray, P: jnp.ndarray, z: jnp.ndarray,
                    h_fn, row_mask: jnp.ndarray, r_diag: jnp.ndarray,
                    num_iters: int = 3):
    """Iterated EKF (Gauss-Newton) measurement update.

    Implements the intent of the reference's non-functional IEKF path
    (ekf_update_iterated.m:1-4 calls a missing update_iterated, SURVEY.md
    §2.9): relinearize h and H about the current iterate x_i, with the
    standard IEKF innovation correction nu_i = z − h(x_i) − H_i (x̂ − x_i),
    then apply the covariance update once at the final linearization point.

    h_fn: x -> (h (M,), H (M, D)) evaluated at x (rows for inactive
    measurements must be zero in H and arbitrary in h — they are masked).
    """
    dtype = x.dtype
    mask = row_mask.astype(dtype)
    r_eff = jnp.where(row_mask, r_diag, jnp.ones_like(r_diag))
    x0 = x
    Pc = p_compute(P)

    def gain(xi):
        h, H = h_fn(xi)
        H = H * mask[:, None]
        PHt = Pc @ H.T
        S = H @ PHt + jnp.diag(r_eff)
        K = PHt @ _spd_inverse(S)
        return h, H, PHt, K

    def body(_, xi):
        h, H, PHt, K = gain(xi)
        nu = (z - h) * mask - H @ (x0 - xi)
        return x0 + K @ nu

    xi = jax.lax.fori_loop(0, num_iters, body, x)
    # Final covariance at the last linearization point.
    _, _, PHt, K = gain(xi)
    P_new = Pc - K @ PHt.T
    P_new = 0.5 * (P_new + P_new.T)
    xi, P_new = _renormalize_quaternion(xi, P_new)
    return xi, p_store(P_new, P)
