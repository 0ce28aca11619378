"""Quantify the bf16-P fast mode's accuracy at the HEADLINE operating
point: B=256, CAP=100, M=24, NHYP=64, FRAMES=16 —
the exact bench.py scenario and key schedule.

Three legs, run as separate processes (EKF_COV_PRECISION is read at
ekf.py import, so precision must be fixed before the package loads):

    python tools/measure_pstore_drift.py bf16   # fast mode (GPU): bf16-P storage
    python tools/measure_pstore_drift.py f32    # parity mode (GPU): f32-P storage
    python tools/measure_pstore_drift.py f64    # float64 oracle-dtype engine (CPU, B=4)
    python tools/measure_pstore_drift.py compare

Each leg writes runs/r3a/drift_<mode>.npz (trajectories + ground truth).
`compare` prints the accuracy table: per-mode mean
position error vs ground truth, and pairwise trajectory RMSE
(bf16-vs-f32, each-vs-f64 on the shared first 4 instances — per-instance
keys are the first 4 of the B=256 split, so the legs are comparable).

Reference anchor: update.m:13-14 (the symmetrize step) is where bf16
storage rounding concentrates; the number this produces is the measured
end-to-end drift of that rounding over the full 16-frame pipeline.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODE = sys.argv[1] if len(sys.argv) > 1 else "compare"
OUT = os.path.join(os.path.dirname(__file__), "..", "runs", "r3a")

if MODE == "bf16":
    os.environ["EKF_COV_PRECISION"] = "tensorfloat32"
elif MODE in ("f32", "f64"):
    os.environ["EKF_COV_PRECISION"] = "float32"

import numpy as np  # noqa: E402


def run_leg(mode: str):
    import jax
    if mode == "f64":
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from ekf_slam_tpu.config import (EngineConfig, FilterConfig, MapConfig,
                                     RansacConfig, SimConfig)
    from ekf_slam_tpu.filter import engine
    from ekf_slam_tpu.filter.state import init_state

    B_FULL = 256
    B = 4 if mode == "f64" else B_FULL
    FRAMES = 16
    cfg = EngineConfig(
        filter=FilterConfig(
            gain_solver="newton",
            p_storage="bf16" if mode == "bf16" else "f32"),
        map=MapConfig(capacity=100, min_features_in_image=25,
                      max_new_per_step=10, max_update_obs=24),
        ransac=RansacConfig(num_hypotheses=64),
        sim=SimConfig(num_landmarks=128),
        dtype="float64" if mode == "f64" else "float32")

    # Scenario ALWAYS generated in float32 (the bench's) so every leg
    # filters the identical observations; the f64 leg upcasts.
    f32cfg = cfg if mode != "f64" else EngineConfig(
        filter=FilterConfig(gain_solver="newton"),
        map=MapConfig(capacity=100, min_features_in_image=25,
                      max_new_per_step=10, max_update_obs=24),
        ransac=RansacConfig(num_hypotheses=64),
        sim=SimConfig(num_landmarks=128), dtype="float32")
    from ekf_slam_tpu.sim import simulate
    scn, xs, obs = simulate(jax.random.key(0), f32cfg, FRAMES)
    if mode == "f64":
        obs = jax.tree.map(
            lambda a: a.astype(jnp.float64)
            if jnp.issubdtype(a.dtype, jnp.floating) else a, obs)

    st = engine.bootstrap(
        init_state(cfg), jax.tree.map(lambda a: a[0], obs), cfg)
    st_b = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), st)
    # bench.py's warmup key schedule: instance i gets split(key(1), 256)[i].
    keys = jax.random.split(jax.random.key(1), B_FULL)[:B]

    @jax.jit
    def run(states, ks):
        final, traj, infos = jax.vmap(
            lambda s, k: engine.run_sequence(s, obs, k, cfg))(states, ks)
        return traj

    traj = np.asarray(run(st_b, keys), dtype=np.float64)
    os.makedirs(OUT, exist_ok=True)
    np.savez(os.path.join(OUT, f"drift_{mode}.npz"),
             traj=traj, xs=np.asarray(xs, dtype=np.float64))
    err = float(np.mean(np.linalg.norm(
        traj[..., 0:3] - np.asarray(xs)[None, :, 0:3], axis=-1)))
    print(f"{mode}: traj {traj.shape}, mean pos err vs ground truth "
          f"{err:.6f}")


def compare():
    legs = {}
    for m in ("bf16", "f32", "f64"):
        p = os.path.join(OUT, f"drift_{m}.npz")
        if os.path.exists(p):
            legs[m] = np.load(p)
    if "bf16" not in legs or "f32" not in legs:
        sys.exit("need at least the bf16 and f32 legs")
    xs = legs["f32"]["xs"]

    def pos_err(traj):
        return float(np.mean(np.linalg.norm(
            traj[..., 0:3] - xs[None, :, 0:3], axis=-1)))

    def rmse(a, b):
        n = min(a.shape[0], b.shape[0])
        return float(np.sqrt(np.mean((a[:n] - b[:n]) ** 2)))

    def pos_rmse(a, b):
        n = min(a.shape[0], b.shape[0])
        d = a[:n, ..., 0:3] - b[:n, ..., 0:3]
        return float(np.sqrt(np.mean(np.sum(d ** 2, axis=-1))))

    print("| leg | mean pos err vs ground truth |")
    print("|---|---|")
    for m, z in legs.items():
        print(f"| {m} | {pos_err(z['traj']):.6f} |")
    print()
    print("| pair | full-state RMSE | position RMSE |")
    print("|---|---|---|")
    b, f = legs["bf16"]["traj"], legs["f32"]["traj"]
    print(f"| bf16 vs f32 | {rmse(b, f):.3e} | {pos_rmse(b, f):.3e} |")
    if "f64" in legs:
        o = legs["f64"]["traj"]
        print(f"| f32 vs f64 | {rmse(f, o):.3e} | {pos_rmse(f, o):.3e} |")
        print(f"| bf16 vs f64 | {rmse(b, o):.3e} | {pos_rmse(b, o):.3e} |")


if MODE == "compare":
    compare()
else:
    run_leg(MODE)
