"""1-point RANSAC, vmapped over a fixed hypothesis batch (L4).

The reference (ransac_hypotheses.m:1-47) runs a sequential adaptive loop:
draw one IC match, do a 1-match *state-only* EKF update (K = P Hᵢᵀ Sᵢ⁻¹,
xᵢ = x⁻ + K(zᵢ − hᵢ), ransac_hypotheses.m:20-26), reproject all matched
features under xᵢ and count residuals below σ_z
(compute_hypothesis_support_fast.m:29-45,68-84), keeping the best and
shrinking the iteration budget via n = log(1−p)/log(ε̂).

Fixed-shape re-design: `cfg.ransac.num_hypotheses` hypotheses are drawn and
scored in parallel (one vmap), and the argmax-support hypothesis wins. For
any inlier ratio where the reference's own adaptive formula terminates
within that budget, the fixed batch stochastically dominates the sequential
loop (it evaluates at least as many independent draws); see
tests/test_ransac.py::test_fixed_batch_support_matches_sequential.

The support projection follows compute_hypothesis_support_fast exactly:
plain project+distort of every *matched* feature (no FoV/in-image gating)
with residual threshold = σ_z (ransac_hypotheses.m:6).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from ekf_slam_tpu.config import CAM_DIM, EngineConfig
from ekf_slam_tpu.filter import association
from ekf_slam_tpu.filter.ekf import f32_matmuls as _f32
from ekf_slam_tpu.ops import camera as cam_ops
from ekf_slam_tpu.ops import quaternion as quat

# Support-scoring layout: "soa" evaluates ALL hypotheses on (CAP, NHYP)
# structure-of-arrays slices of the (D, NHYP) hypothesis matrix — no
# intermediate carries a trailing 2/3/6 dim (under the vmapped form the
# v @ R_wc inputs are (B,NHYP,CAP,3) — small-minor-dim arrays that tiled
# layouts pad many-fold). "vmap" keeps the
# per-hypothesis form for A/B; test_ransac pins soa == vmap.
_FORM = os.environ.get("EKF_RANSAC", "soa")

# Hypothesis-apply operand form: "gform" (default) contracts P against
# the (D, NHYP) sparse factor Hᵀ·A built from the picked slots' Jacobian
# blocks — one natural-layout P read; "pht" builds all-slot gain columns
# P·Hᵀ (D, 2·CAP) first (measurement.pht_slots) and contracts those —
# the pre-r2d form, kept for A/B (and always used when the engine shares
# a pht/hp operand across stages).
_APPLY = os.environ.get("EKF_RANSAC_APPLY", "gform")


def sample_ic_indices(key: jax.Array, ic_mask: jnp.ndarray,
                      num: int) -> jnp.ndarray:
    """Draw `num` slot indices uniformly among IC matches
    (select_random_match.m:1-21). Falls back to slot 0 when no IC match
    exists (callers mask the whole RANSAC phase on that case)."""
    cap = ic_mask.shape[0]
    n_ic = jnp.sum(ic_mask)
    u = jax.random.uniform(key, (num,))
    ranks = jnp.floor(u * n_ic).astype(jnp.int32)        # in [0, n_ic)
    # slot of the k-th IC match: first index where cumsum(ic) == k+1
    csum = jnp.cumsum(ic_mask.astype(jnp.int32))
    # searchsorted over the monotone cumsum gives the first such slot.
    slots = jnp.searchsorted(csum, ranks + 1)
    return jnp.clip(slots, 0, cap - 1)


def support_projection(x_hyp: jnp.ndarray, cartesian: jnp.ndarray,
                       cfg: EngineConfig) -> jnp.ndarray:
    """Reproject every slot under hypothesis state x_hyp — the batched
    reprojection of compute_hypothesis_support_fast.m (no gating).
    Returns (CAP, 2) distorted pixels."""
    cap = cartesian.shape[0]
    cam = cfg.camera
    slots = x_hyp[CAM_DIM:].reshape(cap, 6)
    t_wc = x_hyp[0:3]
    R_wc = quat.q2r(x_hyp[3:7])
    y3 = slots[:, 0:3]
    mi = quat.azel_to_ray(slots[:, 3], slots[:, 4])
    v_id = (y3 - t_wc) * slots[:, 5:6] + mi
    v = jnp.where(cartesian[:, None], y3 - t_wc, v_id)
    hc = v @ R_wc
    # Avoid 0/0 on dead slots (projection of the origin).
    hz = jnp.where(hc[:, 2] == 0, jnp.ones_like(hc[:, 2]), hc[:, 2])
    hc = hc.at[:, 2].set(hz)
    return cam_ops.distort(cam_ops.project(hc, cam), cam)


def support_residuals_soa(x_hyps: jnp.ndarray, z: jnp.ndarray,
                          cartesian: jnp.ndarray,
                          cfg: EngineConfig) -> jnp.ndarray:
    """Squared reprojection residuals of every slot under every
    hypothesis, structure-of-arrays: x_hyps (D, N) -> res2 (CAP, N).

    Same math as support_projection (compute_hypothesis_support_fast.m
    reprojection, q2r / m.m / hu.m / distort_fm.m unrolled per
    component); every intermediate is (CAP, N) or (N,) — large minor
    dims, nothing to pad."""
    cap = cartesian.shape[0]
    cam = cfg.camera
    dt = x_hyps.dtype
    m = x_hyps[CAM_DIM:, :]                              # (6*CAP, N)
    yx, yy, yz = m[0::6], m[1::6], m[2::6]               # (CAP, N)
    az, el, rho = m[3::6], m[4::6], m[5::6]
    tx, ty, tz = x_hyps[0], x_hyps[1], x_hyps[2]         # (N,)
    qr, qx, qy, qz = x_hyps[3], x_hyps[4], x_hyps[5], x_hyps[6]

    # m(θ,φ) = [cosφ sinθ, −sinφ, cosφ cosθ] (m.m:1-16)
    cphi = jnp.cos(el)
    mx, my, mz = cphi * jnp.sin(az), -jnp.sin(el), cphi * jnp.cos(az)
    dx, dy, dz = yx - tx, yy - ty, yz - tz
    cart = cartesian[:, None]
    vx = jnp.where(cart, dx, dx * rho + mx)
    vy = jnp.where(cart, dy, dy * rho + my)
    vz = jnp.where(cart, dz, dz * rho + mz)

    # hc = R_wcᵀ v, R elements from the Davison q2r form (q2r.m:1-10).
    r00 = qr * qr + qx * qx - qy * qy - qz * qz
    r11 = qr * qr - qx * qx + qy * qy - qz * qz
    r22 = qr * qr - qx * qx - qy * qy + qz * qz
    r01, r10 = 2 * (qx * qy - qr * qz), 2 * (qx * qy + qr * qz)
    r02, r20 = 2 * (qz * qx + qr * qy), 2 * (qz * qx - qr * qy)
    r12, r21 = 2 * (qy * qz - qr * qx), 2 * (qy * qz + qr * qx)
    hx = vx * r00 + vy * r10 + vz * r20
    hy = vx * r01 + vy * r11 + vz * r21
    hz = vx * r02 + vy * r12 + vz * r22
    hz = jnp.where(hz == 0, jnp.ones_like(hz), hz)       # dead slots

    # hu.m pinhole + distort_fm.m Newton, per component.
    fku = jnp.asarray(cam.f / cam.d, dt)
    uu = (hx / hz) * fku                                 # centered*d/d
    vv = (hy / hz) * fku
    d = jnp.asarray(cam.d, dt)
    k1 = jnp.asarray(cam.k1, dt)
    k2 = jnp.asarray(cam.k2, dt)
    xu, yu = uu * d, vv * d
    ru = jnp.sqrt(xu * xu + yu * yu)
    rd = ru / (1.0 + k1 * ru**2 + k2 * ru**4)

    def newton(_, rd):
        f = rd + k1 * rd**3 + k2 * rd**5 - ru
        fp = 1.0 + 3.0 * k1 * rd**2 + 5.0 * k2 * rd**4
        return rd - f / fp

    rd = jax.lax.fori_loop(0, cam.distort_newton_iters, newton, rd)
    D = 1.0 + k1 * rd**2 + k2 * rd**4
    ud = xu / (D * d) + cam.cx
    vd = yu / (D * d) + cam.cy
    du = z[:, 0:1] - ud
    dv = z[:, 1:2] - vd
    return du * du + dv * dv                             # (CAP, N)


@_f32
def run(x: jnp.ndarray, P: jnp.ndarray, z: jnp.ndarray, h: jnp.ndarray,
        H_xv: jnp.ndarray, H_y: jnp.ndarray, S: jnp.ndarray,
        ic_mask: jnp.ndarray, cartesian: jnp.ndarray, key: jax.Array,
        cfg: EngineConfig, pht: jnp.ndarray = None, hp=None):
    """Full 1-point RANSAC. Returns (li_mask, best_support).

    x, P: prior state/covariance. z/h/S: per-slot measurements, predictions
    and innovation covariances from the prior. H_xv (CAP,2,13) / H_y
    (CAP,2,6): per-slot Jacobian blocks. ic_mask: IC slots. pht: optional
    precomputed per-slot gain columns (D, 2·CAP) — the engine shares one
    measurement.pht_slots result between RANSAC and the LI update. hp:
    optional split row-form (hp_u, hp_v), each (CAP, D), from
    measurement.pht_rows_split (EKF_UPDATE=rows sharing) — takes
    precedence over pht; the hypothesis apply becomes two (D, NHYP)
    row-contraction dots, no (D, 2·CAP) columns ever built.
    """
    cap = ic_mask.shape[0]
    nhyp = cfg.ransac.num_hypotheses
    thr = cfg.filter.sigma_z  # RANSAC threshold = std_z (ransac_hypotheses.m:6)

    from ekf_slam_tpu.filter import ekf as _ekf
    from ekf_slam_tpu.filter import measurement
    if hp is not None:
        # Split row-form sharing: x_hyps = x + hp_uᵀ·A_u + hp_vᵀ·A_v,
        # contracting each (CAP, D) hp block over its slot axis. A is
        # laid out (CAP, 2, NHYP) flattened slot-major, so component c's
        # coefficient rows are A[c::2] of the flat (2·CAP, NHYP) form.
        hp_u, hp_v = hp

        def apply_picks(A):
            A3 = A.reshape(cap, 2, -1)
            return (jax.lax.dot_general(hp_u, A3[:, 0, :],
                                        (((0,), (0,)), ((), ())))
                    + jax.lax.dot_general(hp_v, A3[:, 1, :],
                                          (((0,), (0,)), ((), ()))))
    elif pht is None and _ekf._PHT_FORM == "rows":
        # Symmetric row form: one natural-layout P read, no transposed-
        # layout copy of P (measurement.pht_slots_rows). (CAP, 2, D).
        pht2 = measurement.pht_slots_rows(P, H_xv, H_y).reshape(2 * cap, -1)
        apply_picks = lambda A: jnp.einsum("md,mn->dn", pht2, A)
    elif pht is None and _APPLY == "gform":
        # Associativity: x_hyps = x + (P·Hᵀ)·A = x + P·(Hᵀ·A). Hᵀ·A is a
        # (D, NHYP) factor computable from the NHYP picked slots' Jacobian
        # blocks alone (H is block-sparse, A one-hot in the slot axis), so
        # the whole hypothesis apply is ONE natural-layout P read with a
        # 64-wide dot — no (D, 2·CAP) all-slot gain columns (pht_slots:
        # column-sliced P reads feeding 6-wide contraction einsums plus
        # (D,CAP,6)/(D,2·CAP) layout copies).
        apply_picks = None
    else:
        pht2 = measurement.pht_slots(P, H_xv, H_y) if pht is None \
            else pht                                      # (D, 2·CAP)
        apply_picks = lambda A: pht2 @ A

    picks = sample_ic_indices(key, ic_mask, nhyp)         # (NHYP,)

    # All NHYP 1-match state updates as ONE matmul: x_hyp_n = x + P Hₙᵀ wₙ
    # with wₙ = Sₙ⁻¹ νₙ. A (2·CAP, NHYP) scatters each pick's w into its
    # slot's two columns via a one-hot product — the previous per-pick
    # gather of (D, 2) gain columns materialized a (NHYP, D, 2) array
    # with a minor dim of 2 (a many-fold padded layout on tiled memory).
    nu_p = z[picks] - h[picks]                            # (NHYP, 2)
    w_p = jax.vmap(association._solve_2x2)(S[picks], nu_p)
    onehot = jax.nn.one_hot(picks, cap, dtype=x.dtype)    # (NHYP, CAP)
    if apply_picks is None:
        # G = Hᵀ·A directly from the picked blocks: camera rows from
        # Hxvᵀw, each pick's 6 map rows scattered via the slot one-hot.
        cam_g = jnp.einsum("nij,ni->jn", H_xv[picks], w_p)    # (13, N)
        slot_g = jnp.einsum("nij,ni->nj", H_y[picks], w_p)    # (N, 6)
        map_g = jnp.einsum("nc,nj->cjn", onehot, slot_g
                           ).reshape(6 * cap, nhyp)           # (6CAP, N)
        G = jnp.concatenate([cam_g, map_g], axis=0)           # (D, N)
        x_hyps = x[:, None] + _ekf.p_compute(P) @ G
    else:
        A = jnp.einsum("nc,nj->cjn", onehot, w_p).reshape(2 * cap, nhyp)
        x_hyps = x[:, None] + apply_picks(A)              # (D, NHYP)

    if _FORM == "soa":
        res2 = support_residuals_soa(x_hyps, z, cartesian, cfg)  # (CAP, N)
        inliers = ic_mask[:, None] & (res2 < thr * thr)
        supports = jnp.sum(inliers, axis=0)                      # (N,)
        best = jnp.argmax(supports)
        any_ic = jnp.any(ic_mask)
        li_mask = inliers[:, best] & any_ic
        return li_mask, jnp.where(any_ic, supports[best], 0)

    def one_hypothesis(x_hyp):
        h_all = support_projection(x_hyp, cartesian, cfg)
        res2 = jnp.sum((z - h_all) ** 2, axis=-1)
        inlier = ic_mask & (res2 < thr * thr)
        return inlier, jnp.sum(inlier)

    inliers, supports = jax.vmap(one_hypothesis, in_axes=1)(x_hyps)
    best = jnp.argmax(supports)
    any_ic = jnp.any(ic_mask)
    li_mask = inliers[best] & any_ic
    return li_mask, jnp.where(any_ic, supports[best], 0)
