"""Localize the first non-finite intermediate of the EKF_UPDATE=rows step
on the real backend at the bench fast-mode config (bf16-P storage +
tensorfloat32 covariance dots + M=48).

One jitted scan over frames computes every stage intermediate of
engine.step_core_from_prior and returns per-frame finiteness flags plus a
few scalar diagnostics — one compile localizes the failure instead of one
bench round-trip per hypothesis.

Usage: python tools/probe_rows_nan.py   (env knobs as bench.py)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

os.environ.setdefault("EKF_COV_PRECISION", "tensorfloat32")
os.environ.setdefault("EKF_UPDATE", "rows")

import jax

if os.environ.get("PROBE_CPU"):  # fast syntax/shape check off-device
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

from ekf_slam_tpu.config import (EngineConfig, FilterConfig, MapConfig,
                                 RansacConfig, SimConfig)
from ekf_slam_tpu.filter import association, ekf, engine, mapman, measurement, ransac
from ekf_slam_tpu.filter.state import init_state
from ekf_slam_tpu.sim import simulate

B = int(os.environ.get("BENCH_BATCH", "8"))
T = int(os.environ.get("BENCH_FRAMES", "8"))


def fin(a):
    return jnp.all(jnp.isfinite(a))


def step_flags(state, obs, key, cfg):
    """engine.step with a finiteness flag per stage intermediate."""
    f = cfg.filter
    cap = state.capacity
    z, z_valid = engine.gather_measurements(state, obs)
    state = mapman.manage(state, cfg)
    x_prior, P_prior = ekf.predict(state.x, state.P, f)
    h, visible, H_xv, H_y = engine._linearize(x_prior, P_prior, state, cfg)[:4]
    vm = visible.astype(H_xv.dtype)[:, None, None]
    hp = measurement.pht_rows_split(P_prior, H_xv * vm, H_y * vm)
    S = measurement.innovation_covariances_from_hp(
        hp[0], hp[1], H_xv * vm, H_y * vm, f.sigma_z)
    ic = association.individually_compatible(z, z_valid, h, visible, S, cfg)
    li, support = ransac.run(
        x_prior, P_prior, z, h, H_xv * vm, H_y * vm, S, ic,
        state.cartesian, key, cfg, hp=hp)
    x_li, P_li = engine._masked_update_rows(
        x_prior, P_prior, hp, H_xv, H_y, z, h, li, cfg)
    h2, vis2, H_xv2, H_y2 = engine._linearize(x_li, P_li, state, cfg)[:4]
    vm2 = vis2.astype(H_xv2.dtype)[:, None, None]
    hp2 = measurement.pht_rows_split(P_li, H_xv2 * vm2, H_y2 * vm2)
    S_noR = measurement.innovation_covariances_from_hp(
        hp2[0], hp2[1], H_xv2 * vm2, H_y2 * vm2, 0.0)
    hi = association.rescue_high_innovation(z, h2, S_noR, ic & vis2, li, cfg)
    x_hi, P_hi = engine._masked_update_rows(
        x_li, P_li, hp2, H_xv2, H_y2, z, h2, hi, cfg)

    # --- drill into the HI update internals (mirror _masked_update_rows +
    # update_rows step by step) -------------------------------------------
    M = cfg.map.max_update_obs
    sel = jnp.argsort(~hi)[:M]
    sel_mask = hi[sel]
    Hc = measurement.compact_dense_H_block(
        H_xv2[sel], H_y2[sel], sel, sel_mask, cap)
    HPr = jnp.concatenate([hp2[0][sel], hp2[1][sel]], axis=0)
    rmask = jnp.tile(sel_mask, 2).astype(Hc.dtype)
    Hm = Hc * rmask[:, None]
    HPm = HPr * rmask[:, None]
    r_eff = jnp.where(jnp.tile(sel_mask, 2), 1.0, 1.0)
    with jax.default_matmul_precision(os.environ["EKF_COV_PRECISION"]):
        S_sol = jax.lax.dot_general(
            HPm, Hm, (((1,), (1,)), ((), ()))) + jnp.diag(r_eff)
        Wn = ekf._spd_inverse_newton(S_sol)
        res_n = jnp.max(jnp.abs(S_sol @ Wn - jnp.eye(2 * M)))
        Wc = ekf._spd_inverse(S_sol)
        res_c = jnp.max(jnp.abs(S_sol @ Wc - jnp.eye(2 * M)))
        Wbar = 0.5 * (Wn + Wn.T)
        Nr = Wbar @ HPm
        corr4 = -jax.lax.dot_general(
            HPm[:, 3:7], Nr, (((0,), (0,)), ((), ())))
    hi_diag = {
        "hiHP_err": jnp.max(jnp.abs(
            HPm - Hm @ ekf.p_compute(P_li))),
        "hiS_asym": jnp.max(jnp.abs(S_sol - S_sol.T)),
        "hiS_mindiag": jnp.min(jnp.diagonal(S_sol)),
        "hiS_maxabs": jnp.max(jnp.abs(S_sol)),
        "hiW_newton": fin(Wn), "hi_res_n": res_n,
        "hiW_chol": fin(Wc), "hi_res_c": res_c,
        "hiN": fin(Nr), "hi_corr4": fin(corr4),
    }
    state = state.replace(x=x_hi, P=P_hi)
    state = mapman.update_counters(state, visible, ic)
    state = engine.initialize_features(state, obs, jnp.sum(ic), cfg)

    # S diagnostics gated to gate-relevant slots only.
    Sd = jnp.linalg.det(S)
    flags = {
        "x_prior": fin(x_prior), "P_prior": fin(P_prior),
        "hp_u": fin(hp[0]), "hp_v": fin(hp[1]),
        "S": fin(jnp.where(visible[:, None, None], S, 0.0)),
        "minDetS": jnp.min(jnp.where(visible, Sd, jnp.inf)),
        "li_any": jnp.any(li),
        "x_li": fin(x_li), "P_li": fin(P_li),
        "hp2_u": fin(hp2[0]), "hp2_v": fin(hp2[1]),
        "S_noR": fin(jnp.where(vis2[:, None, None], S_noR, 0.0)),
        "x_hi": fin(x_hi), "P_hi": fin(P_hi),
        "P_final": fin(state.P), "x_final": fin(state.x),
        "maxAbsP": jnp.max(jnp.abs(ekf.p_compute(state.P))),
    }
    flags.update(hi_diag)
    return state, flags


def main():
    cfg = EngineConfig(
        filter=FilterConfig(
            gain_solver=os.environ.get("BENCH_GAIN", "newton"),
            p_storage=os.environ.get("BENCH_PSTORE", "bf16")),
        map=MapConfig(capacity=int(os.environ.get("BENCH_CAP", "100")),
                      min_features_in_image=25, max_new_per_step=10,
                      max_update_obs=int(os.environ.get("BENCH_M", "48"))),
        ransac=RansacConfig(
            num_hypotheses=int(os.environ.get("BENCH_NHYP", "64"))),
        sim=SimConfig(num_landmarks=128),
        dtype="float32")
    scn, xs, obs = simulate(jax.random.key(0), cfg, T)
    st = engine.bootstrap(
        init_state(cfg), jax.tree.map(lambda a: a[0], obs), cfg)
    st_b = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), st)
    keys = jax.random.split(jax.random.key(1), B)

    @jax.jit
    def run(states, ks):
        def one(s0, k):
            def body(s, inp):
                o, kk = inp
                return step_flags(s, o, kk, cfg)
            fkeys = jax.random.split(k, T)
            return jax.lax.scan(body, s0, (obs, fkeys))[1]
        return jax.vmap(one)(states, ks)

    flags = run(st_b, keys)
    flags = jax.tree.map(lambda a: jax.device_get(a), flags)
    names = sorted(flags)
    print("frame  " + "  ".join(names))
    import numpy as np
    for t in range(T):
        row = []
        for n in names:
            v = flags[n][:, t]
            if v.dtype == bool:
                row.append(("ok " if bool(v.all()) else "BAD").ljust(max(len(n), 3)))
            else:
                row.append(f"{float(np.min(v)):.2e}/{float(np.max(v)):.2e}".ljust(max(len(n), 3)))
        print(f"{t:5d}  " + "  ".join(row))


if __name__ == "__main__":
    main()
