"""End-to-end SLAM driver — the mono_slam.m equivalent.

Runs the full pipeline on either the synthetic scene (default; the bundled
image sequence of the reference is absent, SURVEY.md §2.9) or a real PGM
sequence via the native loader, optionally with CALC2 loop closure, and
writes trajectory dumps + plots.

Usage:
  python examples/run_slam.py --frames 60 --batch 4 --out /tmp/slam_out
  python examples/run_slam.py --mode pixels --frames 20 --out /tmp/slam_px
  python examples/run_slam.py --mode sequence --pattern '/data/%04d.pgm' \
      --start 1 --frames 100
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp


def _traj_report(traj, xs):
    """Print the standard trajectory metrics (utils/trajectory.py):
    gauge-aligned ATE (SE3 and Sim3 — the monocular-scale variant) and
    one-frame RPE drift."""
    from ekf_slam_tpu.utils import trajectory as tj
    out = jax.jit(lambda e, g: (
        tj.ate_rmse(e[:, 0:3], g[:, 0:3]),
        tj.ate_rmse(e[:, 0:3], g[:, 0:3], with_scale=True),
        tj.rpe(e[:, 0:3], e[:, 3:7], g[:, 0:3], g[:, 3:7])))(traj, xs)
    ate, ate_s, (rpe_t, rpe_r) = out
    print(f"ATE (SE3-aligned) {float(ate):.4f} | ATE (Sim3) "
          f"{float(ate_s):.4f} | RPE/frame {float(rpe_t):.4f} m, "
          f"{float(rpe_r):.4f} rad")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="sim",
                    choices=["sim", "pixels", "sequence"],
                    help="sim: ground-truth association; pixels: rendered "
                         "frames through the image front-end; sequence: "
                         "real PGM files via the native loader")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--batch", type=int, default=1,
                    help="Monte-Carlo filter instances (sim mode)")
    ap.add_argument("--capacity", type=int, default=64)
    ap.add_argument("--min-features", type=int, default=20)
    ap.add_argument("--landmarks", type=int, default=96)
    ap.add_argument("--pattern", default=None, help="printf PGM pattern")
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--out", default="/tmp/ekf_slam_out")
    ap.add_argument("--plots", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    args = ap.parse_args()

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from ekf_slam_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from ekf_slam_tpu.config import EngineConfig, MapConfig, SimConfig
    from ekf_slam_tpu.filter import engine
    from ekf_slam_tpu.filter.state import init_state
    from ekf_slam_tpu.sim import scene as sim_scene
    from ekf_slam_tpu.utils import MetricsLogger
    from ekf_slam_tpu.utils.checkpoint import dump_trajectory

    os.makedirs(args.out, exist_ok=True)
    cfg = EngineConfig(
        map=MapConfig(capacity=args.capacity,
                      min_features_in_image=args.min_features,
                      max_new_per_step=args.min_features),
        sim=SimConfig(num_landmarks=args.landmarks))

    metrics = MetricsLogger()
    t0 = time.perf_counter()

    if args.mode == "sim":
        scn, xs, obs = sim_scene.simulate(jax.random.key(0), cfg,
                                          args.frames)
        st = engine.bootstrap(init_state(cfg),
                              jax.tree.map(lambda a: a[0], obs), cfg)
        run = jax.jit(engine.run_sequence, static_argnames="cfg")
        if args.batch > 1:
            st_b = jax.tree.map(
                lambda a: jnp.broadcast_to(a, (args.batch,) + a.shape), st)
            keys = jax.random.split(jax.random.key(1), args.batch)
            final, traj, infos = jax.jit(jax.vmap(
                lambda s, k: engine.run_sequence(s, obs, k, cfg)))(st_b, keys)
            traj0 = traj[0]
        else:
            final, traj0, infos = run(st, obs, jax.random.key(1), cfg)
        jax.block_until_ready(traj0)
        err = jnp.linalg.norm(traj0[..., 0:3] - xs[:, 0:3], axis=-1)
        for t in range(args.frames):
            row = jax.tree.map(lambda a: a[..., t] if a.ndim > 1 else a[t],
                               infos)
            metrics.log(t, pos_err=float(err[t]),
                        n_ic=float(jnp.mean(row.n_ic)),
                        n_li=float(jnp.mean(row.n_li)))
        dump_trajectory(os.path.join(args.out, "trajectory.npz"),
                        traj0, truth=xs)
        _traj_report(traj0, xs)
        if args.plots:
            from ekf_slam_tpu.viz import plot_map_3d
            lm = final.slot_values()[..., 0:3]
            lm = lm[0] if args.batch > 1 else lm
            active = final.active[0] if args.batch > 1 else final.active
            plot_map_3d(os.path.join(args.out, "map.png"),
                        traj0[:, 0:3], lm, active=active, truth_traj=xs)

    elif args.mode == "pixels":
        from ekf_slam_tpu.vision import frontend
        scn, xs, _ = sim_scene.simulate(jax.random.key(0), cfg, args.frames)
        render = jax.jit(frontend.render_scene_image, static_argnames="cfg")
        step = jax.jit(frontend.step_image, static_argnames="cfg")
        st, app = init_state(cfg), frontend.init_appearance(cfg)
        traj = []
        for t in range(args.frames):
            img = render(scn, xs[t], cfg)
            st, app, info = step(st, app, img, jax.random.key(100 + t), cfg)
            traj.append(st.x[:13])
            err = float(jnp.linalg.norm(st.x[0:3] - xs[t][0:3]))
            metrics.log(t, pos_err=err, n_ic=int(info.n_ic),
                        n_li=int(info.n_li))
        dump_trajectory(os.path.join(args.out, "trajectory.npz"),
                        jnp.stack(traj), truth=xs)
        _traj_report(jnp.stack(traj), xs)

    else:  # sequence
        from ekf_slam_tpu.io import ImageSequence
        from ekf_slam_tpu.vision import frontend
        assert args.pattern, "--pattern required for sequence mode"
        seq = ImageSequence(args.pattern, args.start, args.frames)
        step = jax.jit(frontend.step_image, static_argnames="cfg")
        st, app = init_state(cfg), frontend.init_appearance(cfg)
        traj = []
        for t in range(args.frames):
            img = jnp.asarray(seq.load(t, 1)[0])
            st, app, info = step(st, app, img, jax.random.key(100 + t), cfg)
            traj.append(st.x[:13])
            metrics.log(t, n_ic=int(info.n_ic), n_li=int(info.n_li))
        dump_trajectory(os.path.join(args.out, "trajectory.npz"),
                        jnp.stack(traj))

    dt = time.perf_counter() - t0
    metrics.dump_jsonl(os.path.join(args.out, "metrics.jsonl"))
    print(metrics.table(last_n=3))
    print(f"\n{args.frames} frames in {dt:.2f}s -> "
          f"{args.frames * max(args.batch, 1) / dt:.1f} steps/s")
    print(f"outputs in {args.out}")


if __name__ == "__main__":
    main()
