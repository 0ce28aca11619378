"""Tensor-parallel EKF-SLAM demo: covariance sharded over a device mesh.

Map capacity scales the joint covariance quadratically (D = 13 + 6*CAP);
this driver runs the full SLAM pipeline with P's rows sharded over the
mesh's 'model' axis (parallel/sharded_filter.py), so per-device
covariance memory is D*D/k. The reference has no model parallelism
anywhere (SURVEY.md §2.8) — this is the beyond-parity capacity path.

On a single-chip/CPU box it demonstrates the path on virtual devices:

  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/run_tp_filter.py --frames 12 --cap 48 --model 4

Prints per-device covariance shard shapes, the mesh collectives'
payload classes, and tracking error vs the synthetic ground truth.
"""

import argparse
import os
import re
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--cap", type=int, default=48)
    ap.add_argument("--landmarks", type=int, default=64)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--model", type=int, default=4,
                    help="model-axis size (covariance shards)")
    ap.add_argument("--data", type=int, default=None,
                    help="data-axis size (default: devices // model)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (virtual devices)")
    args = ap.parse_args()

    # Make sure enough devices exist before jax initializes: virtual CPU
    # devices back the demo on single-chip/CPU boxes.
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    if args.cpu or jax.device_count() < args.model:
        jax.config.update("jax_platforms", "cpu")
    from ekf_slam_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp

    from ekf_slam_tpu.config import (EngineConfig, FilterConfig, MapConfig,
                                     SimConfig)
    from ekf_slam_tpu.filter import engine
    from ekf_slam_tpu.filter.state import init_state
    from ekf_slam_tpu.parallel import sharded_filter as sf
    from ekf_slam_tpu.parallel.mesh import make_mesh
    from ekf_slam_tpu.sim import simulate

    n_data = args.data or max(1, jax.device_count() // args.model)
    mesh = make_mesh(data=n_data, model=args.model)
    cfg = EngineConfig(
        map=MapConfig(capacity=args.cap,
                      min_features_in_image=min(20, args.cap // 2),
                      max_new_per_step=min(20, args.cap // 2)),
        sim=SimConfig(num_landmarks=args.landmarks))
    D, Dp = sf.padded_dim(cfg, args.model)
    print(f"mesh data={n_data} x model={args.model}; D={D} (padded {Dp}); "
          f"per-device P rows {Dp // args.model} "
          f"({Dp // args.model * Dp * 4 / 2**20:.2f} MiB/instance vs "
          f"{D * D * 4 / 2**20:.2f} unsharded)")

    scn, xs, obs = simulate(jax.random.key(0), cfg, args.frames)
    st = engine.bootstrap(init_state(cfg),
                          jax.tree.map(lambda a: a[0], obs), cfg)
    B = args.batch * n_data
    st_b = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), st)

    step = sf.make_sharded_step(cfg, mesh)
    sharded = sf.shard_state_batch(st_b, mesh, cfg)

    # collective inventory of the compiled step
    obs1 = jax.tree.map(lambda a: a[1], obs)
    keys = jax.random.split(jax.random.key(1), B)
    txt = step.lower(sharded, obs1, keys).compile().as_text()
    colls = sf.collective_inventory(txt)
    biggest = 0
    for line in colls:
        m = re.search(r"\w+\[([\d,]*)\]", line)
        if m:
            dims = [int(d) for d in m.group(1).split(",") if d]
            p = 1
            for d in dims:
                p *= d
            biggest = max(biggest, p)
    print(f"{len(colls)} mesh collectives; largest payload {biggest} elems "
          f"({biggest / (Dp * Dp):.2f}x of one P shard-set) — "
          f"full P would be {B // n_data * Dp * D}")

    t0 = time.perf_counter()
    for t in range(1, args.frames):
        obs_t = jax.tree.map(lambda a: a[t], obs)
        keys = jax.random.split(jax.random.key(100 + t), B)
        sharded, info = step(sharded, obs_t, keys)
    jax.block_until_ready(sharded.x)
    dt = time.perf_counter() - t0

    out = sf.unpad_state(jax.device_get(sharded), D)
    err = jnp.linalg.norm(out.x[:, 0:3] - xs[args.frames - 1, 0:3][None],
                          axis=-1)
    print(f"{args.frames - 1} frames x {B} instances in {dt:.2f}s; "
          f"finite={bool(jnp.all(jnp.isfinite(out.P)))}; "
          f"pos err at last frame: {[round(float(e), 4) for e in err]}")


if __name__ == "__main__":
    main()
