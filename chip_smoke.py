"""Smoke test of the EKF-SLAM main path on the GPU, at full width.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --multichip   # four GPUs: the two mesh paths only

One GPU, phases (each in its own child process, one after another; this
parent process never imports JAX, so only one process holds the card):

  sim_fast     bench.py's sim fast mode: vmap(engine.run_sequence), CAP=100
               (D=613), M=24, 64 RANSAC hypotheses, Newton gain, bf16 P,
               B=256, 16 frames; bench.py's gates.
  sim_parity   the parity mode: f32 P, M=64, B=128; same gates.
  pixels       bench.py's pixels mode: frontend.step_image at 320x240 with
               the descriptor matcher (four staggered 16-instance chains).
  oracle       the engine on the card against the float64 oracle
               (oracle/pipeline.py): (a) the golden setup (CAP=20, 24
               frames, float64): RMSE <= 1e-6 and equal IC/LI/HI counts and
               RANSAC support every frame; (b) the f32 parity mode at
               CAP=100 over the 16-frame bench horizon: counts equal every
               frame and RMSE <= ORACLE_F32_BOUND.
  precision    sim_fast again with the other matmul precision (float32
               vs tensorfloat32 = TF32 tensor cores); both sets of gate
               values are reported, and the non-default one's gate
               failures are a finding, not a phase failure.

Four GPUs (--multichip), and nothing else:
  (a) parallel.mesh.run_ensemble on a 4-device ("data",) mesh at the
      sim_fast configuration (B=256, 64 per device) and with f32 P, each
      instance compared with the same key run through a one-device vmap
      (64-instance chunks): equal after the first frame, ensemble
      statistics equal, the full-horizon agreement reported;
  (b) parallel.sharded_filter.make_sharded_step with model=4 at CAP=100
      (D=613 padded to 616) for a few frames, compared with the unsharded
      engine.step on one device; the compiled GPU HLO must hold no
      collective that moves a full covariance.

Each phase prints its compile seconds, compiled.memory_analysis(), steps/s
and gate values. The last line of standard output is exactly
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
when every phase passed; otherwise the script exits non-zero without it.
It refuses (non-zero, no such line) when JAX finds no GPU.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
TIME_BUDGET_S = 1150           # the whole script, compilation included

# Oracle (b) tolerance. Measured on the CPU (float32, XLA:CPU, this parity
# configuration and seed): the f32 engine tracks the float64 oracle with
# RMSE <= 7.834e-6 over the 16 frames, counts equal every frame. The GPU
# run at EKF_COV_PRECISION=float32 (true f32 matmuls in the whole step)
# may reorder sums (cuBLAS blocking, tree reductions) and runs the
# Newton-Schulz fast phase at default precision (TF32) before its f32
# refinement, so it is held to 10x the CPU bound; TF32 leakage into the
# step's other matmuls (2^-11 relative) shows as RMSE ~1e-3 from the first
# frame and fails it.
ORACLE_F32_CPU_RMSE = 7.834e-6
ORACLE_F32_BOUND = 10 * ORACLE_F32_CPU_RMSE
ORACLE_F32_FRAMES = 16

# (phase, child environment) for one GPU, in run order.
PHASES = [
    ("sim_fast", {}),
    ("sim_parity", {"BENCH_PSTORE": "f32", "BENCH_M": "64"}),
    ("pixels", {"BENCH_MODE": "pixels"}),
    ("oracle_golden", {"JAX_ENABLE_X64": "1"}),
    ("oracle_f32", {"BENCH_PSTORE": "f32"}),
    ("precision", {}),
]


# ------------------------------------------------------------ phase bodies
# Each returns (results dict, list of gate failures). Sizes default to the
# full configuration; tests rehearse them at tiny sizes on the CPU.

def phase_sim(batch=None, frames=None, **cfg_kw):
    import bench
    cfg = bench.sim_config(**cfg_kw)
    res = bench.run_sim(cfg, batch or bench.BATCH, frames or bench.FRAMES)
    return res, bench.sim_gate_failures(res)


def phase_pixels(batch=None, frames=None, chains=None, **cfg_kw):
    import bench
    cfg = bench.pixels_config(**cfg_kw)
    dflt_chains, dflt_batch = bench.pixels_chains_and_batch(cfg)
    chains = dflt_chains if chains is None else chains
    res = bench.run_pixels(cfg, batch or dflt_batch,
                           frames or bench.FRAMES, chains)
    return res, bench.pixels_gate_failures(res)


def _count_mismatches(counts_equal):
    bad = [t + 1 for t, c in enumerate(counts_equal) if not c]
    return [f"IC/LI/HI counts differ from the oracle at frames {bad}"] \
        if bad else []


def phase_oracle_golden(frames=24):
    """(a): the golden-test setup, float64, on this process's device."""
    import jax

    from ekf_slam_tpu.filter import engine
    from ekf_slam_tpu.oracle.pipeline import (compare_with_oracle,
                                              golden_config)
    from ekf_slam_tpu.sim import simulate

    cfg = golden_config()
    if not jax.config.jax_enable_x64:
        return {}, ["oracle_golden needs JAX_ENABLE_X64=1"]
    _, _, obs = simulate(jax.random.key(4), cfg, frames)
    step = jax.jit(engine.step, static_argnames="cfg")
    res = compare_with_oracle(
        cfg, obs, lambda s, o, k: step(s, o, k, cfg),
        key_fn=lambda t: jax.random.key(300 + t),
        force_convert_at=frames // 2)
    out = {"frames": frames, "bootstrap_rmse": res["bootstrap_rmse"],
           "final_rmse": res["rmse"][-1], "max_rmse": max(res["rmse"]),
           "counts_equal_frames": sum(res["counts_equal"]),
           "converted": res["converted"]}
    fails = []
    fails += _count_mismatches(res["counts_equal"])
    if not res["rmse"][-1] <= 1e-6:
        fails.append(f"final RMSE {res['rmse'][-1]:.3e} > 1e-6")
    if not res["converted"]:
        fails.append("conversion never exercised")
    return out, fails


def phase_oracle_f32(frames=ORACLE_F32_FRAMES, bound=ORACLE_F32_BOUND,
                     **cfg_kw):
    """(b): the float32 parity mode against the float64 oracle, one
    instance over the bench horizon."""
    import jax

    import bench
    from ekf_slam_tpu.filter import ekf, engine
    from ekf_slam_tpu.oracle.pipeline import compare_with_oracle
    from ekf_slam_tpu.sim import simulate

    cfg_kw.setdefault("pstore", "f32")
    cfg_kw.setdefault("m", 64)
    cfg = bench.sim_config(**cfg_kw)
    _, _, obs = simulate(jax.random.key(0), cfg, frames + 1)
    step = jax.jit(engine.step, static_argnames="cfg")
    res = compare_with_oracle(
        cfg, obs, lambda s, o, k: step(s, o, k, cfg),
        key_fn=lambda t: jax.random.fold_in(jax.random.key(1), t))
    out = {"frames": frames, "rmse": res["rmse"], "bound": bound,
           "max_rmse": max(res["rmse"]),
           "counts_equal_frames": sum(res["counts_equal"]),
           "precision": ekf._COV_PRECISION}
    fails = []
    fails += _count_mismatches(res["counts_equal"])
    if not out["max_rmse"] <= bound:
        fails.append(f"max RMSE {out['max_rmse']:.3e} > bound {bound:.3e}")
    return out, fails


def phase_multichip(batch=256, frames=16, tp_frames=3, tp_batch=4,
                    n_dev=4, cap=None, tol=1e-3):
    """Both multi-device paths on an n_dev mesh, each against one
    device."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from ekf_slam_tpu.filter import engine
    from ekf_slam_tpu.filter.state import init_state
    from ekf_slam_tpu.parallel import mesh as pmesh
    from ekf_slam_tpu.parallel import sharded_filter as sf
    from ekf_slam_tpu.sim import simulate

    devs = jax.devices()
    if len(devs) < n_dev:
        return {}, [f"needs {n_dev} devices, found {len(devs)}"]
    out, fails = {}, []

    # (a) data-parallel Monte-Carlo ensemble vs one-device vmap, at the
    # fast configuration (bf16 P) and with f32 P. The one-device
    # reference runs the same keys through vmap in per-device-sized
    # chunks. The mesh program is compiled separately, so sums may run in
    # another order; bf16 storage of P can turn such a 1e-7 difference
    # into a different rounding and, frames later, a different RANSAC or
    # gate decision. So every instance must agree after its first frame
    # (1e-4), the ensemble statistics must agree (10%) and pass the sim
    # gates, and the per-instance agreement over the whole horizon is
    # reported.
    mesh = pmesh.make_mesh(devices=devs[:n_dev])
    per = batch // n_dev
    for tag, cfg in (("fast", bench.sim_config(cap=cap)),
                     ("f32P", bench.sim_config(cap=cap, pstore="f32",
                                               m=64))):
        _, xs, obs = simulate(jax.random.key(0), cfg, frames)
        st = engine.bootstrap(init_state(cfg),
                              jax.tree.map(lambda a: a[0], obs), cfg)
        st_b = jax.tree.map(
            lambda a: jnp.broadcast_to(a, (batch,) + a.shape), st)
        keys = jax.random.split(jax.random.key(1), batch)
        t0 = time.perf_counter()
        _, traj, mean, _ = pmesh.run_ensemble(st_b, obs, keys, cfg, mesh)
        jax.block_until_ready(traj)
        out[f"{tag}_ensemble_first_call_s"] = time.perf_counter() - t0
        out[f"{tag}_traj_shards"] = sorted(
            {tuple(s.data.shape) for s in traj.addressable_shards})
        one = jax.jit(jax.vmap(
            lambda s, k, obs=obs, cfg=cfg: engine.run_sequence(
                s, obs, k, cfg)[1]))
        on0 = jax.device_put((st_b, keys), devs[0])
        ref = np.concatenate([np.asarray(one(*jax.tree.map(
            lambda a, j=j: a[j * per:(j + 1) * per], on0)))
            for j in range(n_dev)])
        traj_h, xs_h = np.asarray(traj), np.asarray(xs)
        d = np.max(np.abs(traj_h - ref), axis=-1)            # (B, T)
        over = np.max(d, axis=1) > tol
        out[f"{tag}_frame1_max_abs_diff"] = float(np.max(d[:, 0]))
        out[f"{tag}_max_abs_diff"] = float(np.max(d))
        out[f"{tag}_instances_over_tol"] = int(np.sum(over))
        out[f"{tag}_first_frame_over_tol"] = sorted(
            int(np.argmax(d[i] > tol)) + 1 for i in np.flatnonzero(over))[:8]
        out[f"{tag}_mean_err"] = float(np.max(np.abs(
            np.asarray(mean) - traj_h.mean(axis=0))))
        stats = {}
        for name, tr in (("mesh", traj_h), ("one_device", ref)):
            stats[name] = (float(np.mean(np.linalg.norm(
                tr[..., 0:3] - xs_h[None, :, 0:3], axis=-1))),
                bench.ensemble_ate(tr, xs_h)[1])
            out[f"{tag}_{name}_tracking_err"], out[f"{tag}_{name}_ate_p95"] \
                = stats[name]
            if not (stats[name][0] < 0.2 and stats[name][1] < 0.15):
                fails.append(f"{tag}: {name} run outside the sim gates")
        if not out[f"{tag}_frame1_max_abs_diff"] <= 1e-4:
            fails.append(f"{tag}: instances differ after the first frame "
                         f"by {out[f'{tag}_frame1_max_abs_diff']:.3e}")
        if not abs(stats["mesh"][0] - stats["one_device"][0]) \
                <= 0.1 * stats["one_device"][0]:
            fails.append(f"{tag}: ensemble tracking error differs by >10%")
        if not out[f"{tag}_mean_err"] < 1e-4:
            fails.append(f"{tag}: ensemble mean disagrees with the "
                         f"trajectories")

    # (b) tensor-parallel covariance step vs the unsharded step
    tcfg = bench.sim_config(cap=cap, pstore="f32", m=64)
    D, Dp = sf.padded_dim(tcfg, n_dev)
    out["tp_D"], out["tp_Dp"] = D, Dp
    _, _, tobs = simulate(jax.random.key(0), tcfg, tp_frames + 1)
    tst = engine.bootstrap(init_state(tcfg),
                           jax.tree.map(lambda a: a[0], tobs), tcfg)
    tst_b = jax.tree.map(
        lambda a: jnp.broadcast_to(a, (tp_batch,) + a.shape), tst)
    tmesh = pmesh.make_mesh(data=1, model=n_dev, devices=devs[:n_dev])
    step = sf.make_sharded_step(tcfg, tmesh)
    sharded = sf.shard_state_batch(tst_b, tmesh, tcfg)
    obs1 = jax.tree.map(lambda a: a[1], tobs)
    fkeys = [jax.random.split(jax.random.key(100 + t), tp_batch)
             for t in range(1, tp_frames + 1)]
    txt = step.lower(sharded, obs1, fkeys[0]).compile().as_text()
    colls = sf.collective_inventory(txt)
    # Every collective must be factor-class, O(D * rows) with rows one of
    # the step's tall-skinny factor widths — never the O(D * D) covariance
    # (the bound tests/test_sharded_filter.py pins on the CPU).
    b_local = tp_batch // tmesh.shape["data"]
    m_rows = min(tcfg.map.max_update_obs or tcfg.map.capacity,
                 tcfg.map.capacity)
    factor_rows = max(12 * tcfg.map.max_new_per_step, 4 * m_rows + 8,
                      tcfg.ransac.num_hypotheses)
    limit = b_local * Dp * factor_rows
    big = [c[:160] for c in colls if sf.collective_payload(c) > limit]
    out["tp_collectives"] = len(colls)
    out["tp_largest_collective_elems"] = max(
        [sf.collective_payload(c) for c in colls], default=0)
    out["tp_factor_limit_elems"] = limit
    out["tp_full_P_elems"] = b_local * Dp * D
    if not colls:
        fails.append("the TP step holds no collectives")
    if not limit < b_local * Dp * D:
        fails.append("factor bound is not below the full-P size")
    if big:
        fails.append(f"covariance-sized collectives: {big}")
    ref_step = jax.jit(jax.vmap(lambda s, o, k: engine.step(s, o, k, tcfg),
                                in_axes=(0, None, 0)))
    ref = jax.device_put(tst_b, devs[0])
    for t in range(1, tp_frames + 1):
        obs_t = jax.tree.map(lambda a: a[t], tobs)
        sharded, _ = step(sharded, obs_t, fkeys[t - 1])
        ref, _ = ref_step(ref, obs_t, jax.device_put(fkeys[t - 1], devs[0]))
    got = sf.unpad_state(jax.device_get(sharded), D)
    ref = jax.device_get(ref)
    out["tp_shard_shapes"] = sorted(
        {tuple(s.data.shape) for s in sharded.P.addressable_shards})
    out["tp_x_max_abs_diff"] = float(np.max(np.abs(
        np.asarray(got.x) - np.asarray(ref.x))))
    out["tp_P_max_abs_diff"] = float(np.max(np.abs(
        np.asarray(got.P) - np.asarray(ref.P))))
    # Sharded and unsharded steps sum in different orders; the Newton
    # gain and the inverse-depth entries (|rho| up to ~10) carry that as
    # relative error, hence rtol next to test_sharded_filter's atol.
    if not np.allclose(np.asarray(got.x), np.asarray(ref.x),
                       rtol=1e-3, atol=2e-4):
        fails.append(f"TP state differs by {out['tp_x_max_abs_diff']:.3e}")
    if not np.allclose(np.asarray(got.P), np.asarray(ref.P),
                       rtol=1e-3, atol=2e-3):
        fails.append("TP covariance differs beyond rtol 1e-3 / atol 2e-3")
    for f in ("active", "cartesian", "landmark_id", "times_measured"):
        if not np.array_equal(np.asarray(getattr(got, f)),
                              np.asarray(getattr(ref, f))):
            fails.append(f"TP {f} differs from the unsharded step")
    return out, fails


# ------------------------------------------------------------ child side

def child(phase: str) -> int:
    """Run one phase in this process and print its JSON as the last
    line. Exit 3 (no work done) when the backend is not the GPU."""
    import jax

    import bench
    info = bench.device_info()
    device = {"platform": info["platform"], "kind": info["device_kind"],
              "count": info["device_count"]}
    if device["platform"] != "gpu":
        print(json.dumps({"phase": phase, "ok": False, "device": device,
                          "refused": "JAX backend is not the GPU"}))
        return 3
    bench.enable_compile_cache()
    if phase in ("sim_fast", "sim_parity", "precision"):
        from ekf_slam_tpu.filter import ekf
        res, fails = phase_sim()
        res["precision"] = ekf._COV_PRECISION
        if phase == "precision":
            # The other precision's gate values are the finding (the
            # default is chosen from them); the phase passes once they
            # are measured.
            res["gate_failures"], fails = fails, []
    elif phase == "pixels":
        res, fails = phase_pixels()
    elif phase == "oracle_golden":
        res, fails = phase_oracle_golden()
    elif phase == "oracle_f32":
        res, fails = phase_oracle_f32()
    elif phase == "multichip":
        res, fails = phase_multichip()
    else:
        raise SystemExit(f"unknown phase {phase}")
    stats = jax.devices()[0].memory_stats() or {}
    res["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    print(json.dumps({"phase": phase, "ok": not fails, "failures": fails,
                      "device": device, "results": res}, default=float))
    return 0 if not fails else 1


# ----------------------------------------------------------- parent side

def _nvidia_smi():
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return None, str(e)
    if r.returncode:
        return None, r.stderr.strip()
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()], ""


def parent(phases) -> int:
    if not os.path.isdir(os.path.join(REPO, "ekf_slam_tpu")):
        print("chip_smoke.py: the ekf_slam_tpu package is not beside this "
              "script", file=sys.stderr)
        return 2
    cards, err = _nvidia_smi()
    if cards:
        for ln in cards:
            print(ln)
    else:
        print(f"nvidia-smi: unavailable ({err})", file=sys.stderr)
    t_start = time.perf_counter()
    device, failed, reports = None, [], {}
    for name, env in phases:
        env = dict(os.environ, **env)
        if name == "precision":
            # sim_fast ran at bench.py's default precision; run the other.
            fast = reports.get("sim_fast", {}).get("results", {}).get(
                "precision")
            env["EKF_COV_PRECISION"] = ("float32" if fast == "tensorfloat32"
                                        else "tensorfloat32")
        left = TIME_BUDGET_S - (time.perf_counter() - t_start)
        if left < 30:
            failed.append(f"{name}: no time left")
            print(f"[{name}] skipped: time budget spent", file=sys.stderr)
            continue
        t0 = time.perf_counter()
        try:
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--phase", name], env=env, cwd=REPO,
                               stdout=subprocess.PIPE, text=True,
                               timeout=left)
        except subprocess.TimeoutExpired:
            failed.append(f"{name}: timed out")
            print(f"[{name}] timed out", file=sys.stderr)
            continue
        lines = r.stdout.splitlines()
        for ln in lines[:-1]:
            print(f"[{name}] {ln}")
        try:
            rep = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            rep = None
        if rep is None:
            failed.append(f"{name}: exit {r.returncode}, no report")
            print(f"[{name}] exit {r.returncode} without a report",
                  file=sys.stderr)
            continue
        if rep.get("refused"):
            print(f"chip_smoke.py: {rep['refused']} "
                  f"({rep['device']}) — refusing", file=sys.stderr)
            return 3
        print(f"[{name}] {time.perf_counter() - t0:.1f} s  "
              + json.dumps(rep))
        device = device or rep["device"]
        reports[name] = rep
        if not rep["ok"] or r.returncode:
            failed.append(f"{name}: {rep.get('failures')}")
    if failed or device is None:
        print("chip_smoke.py: FAILED: " + "; ".join(failed), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the four-GPU mesh paths")
    ap.add_argument("--phase", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.phase:
        sys.path.insert(0, REPO)
        return child(args.phase)
    if args.multichip:
        return parent([("multichip", {})])
    return parent(PHASES)


if __name__ == "__main__":
    sys.exit(main())
