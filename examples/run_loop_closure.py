"""SLAM + CALC2 loop closure, end to end (BASELINE.json configs[4]).

The camera flies a revisit trajectory over a synthetic landmark field; the
EKF engine tracks (drifting over time) while every frame also runs the
CALC2 loop-closure stack (descriptor -> ring DB -> retrieval -> geometric
verify -> temporal consistency). When a loop fires, the stored pose of the
matched frame feeds the filter as a 6-DoF constraint
(filter/loop_fusion.py) — the integration the reference leaves as a text
file (close_kitti_loops.py:141-143, SURVEY.md §1).

Two front-ends (--frontend):
  sim     ground-truth-associated noisy observations (engine.step) — the
          filter-level harness;
  pixels  the REAL image pipeline: render each frame and track with
          vision/frontend.step_image (template warp + matcher + FAST init),
          so drift comes from actual matching, not injected association.

Two trajectories (--traj):
  outback straight out, reverse home (translation revisit);
  pan     a >360-degree panoramic yaw over a surround scene — the classic
          MonoSLAM loop demo: features leave the FoV, the map turns over,
          and the final quarter revisits the start views with accumulated
          drift (the regime where the reference's close_kitti_loops.py
          emits constraints).

Reports per-seed ATE (utils/trajectory.py Umeyama-aligned RMSE) with
fusion ON vs OFF over an ensemble of seeds — the end-to-end number for
"does the loop-closure link pay".

  python examples/run_loop_closure.py --frontend pixels --traj pan \
      --frames 150 --ensemble 4 --cpu --json runs/loop_e2e.json
"""

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def outback_trajectory(cfg, frames):
    """Out-and-back constant-speed trajectory: drift accumulates on the way
    out, the way back revisits the outbound viewpoints."""
    from ekf_slam_tpu.filter import motion
    half = frames // 2
    x = jnp.zeros(13).at[3].set(1.0)
    v_out = jnp.array([0.004, 0.0, 0.006])
    xs = []
    for t in range(frames):
        v = v_out if t < half else -v_out
        x = x.at[7:10].set(v)
        x = motion.fv(x, cfg.filter)
        xs.append(x)
    return jnp.stack(xs)


def pan_trajectory(cfg, frames, total_deg=450.0):
    """Constant-rate panoramic yaw of `total_deg` degrees about the camera
    y axis. 450 deg = one full turn plus a quarter: the last ~20% of frames
    re-see the first quarter's views with a full turn of accumulated
    drift between them."""
    from ekf_slam_tpu.filter import motion
    w = math.radians(total_deg) / frames
    x = jnp.zeros(13).at[3].set(1.0).at[11].set(w)   # omega_y
    xs = []
    for _ in range(frames):
        x = motion.fv(x, cfg.filter)
        xs.append(x)
    return jnp.stack(xs)


def make_surround_scene(key, cfg, n_anchors=12):
    """Landmark field covering a full yaw turn: the frustum sampler
    (sim/scene.make_scene) run from `n_anchors` yaw anchors, each batch
    rotated into place — a surround 'room' so a panning camera always has
    features, but each view's features leave the FoV as it turns."""
    from ekf_slam_tpu.ops.quaternion import q2r
    from ekf_slam_tpu.sim import scene as sim_scene
    parts = []
    for i, k in enumerate(jax.random.split(key, n_anchors)):
        theta = 2.0 * math.pi * i / n_anchors
        q = jnp.array([math.cos(theta / 2), 0.0,
                       math.sin(theta / 2), 0.0])
        pts = sim_scene.make_scene(k, cfg).landmarks @ q2r(q).T
        parts.append(pts)
    return sim_scene.Scene(landmarks=jnp.concatenate(parts, axis=0))


def build_lc_stack(args, T):
    """CALC2 model + LoopConfig. With --ckpt, trained weights (e.g. the
    severity-trained w32 run); otherwise untrained init (descriptors are
    still deterministic functions of the image, so revisits retrieve;
    training sharpens the margin)."""
    from ekf_slam_tpu.models import loopclosure as lc
    from ekf_slam_tpu.models import train
    from ekf_slam_tpu.models.vss import VSSConfig

    model = train.create_model(VSSConfig(width=args.vss_width))
    tcfg = train.TrainConfig(batch_size=2, image_hw=tuple(args.vss_hw))
    tstate = train.init_state(model, tcfg, jax.random.key(2))
    if args.ckpt:
        tstate = train.restore_checkpoint(args.ckpt, tstate)
    variables = {"params": tstate.params, "batch_stats": tstate.batch_stats}
    lcfg = lc.LoopConfig(capacity=max(256, T), top_k=3,
                         exclude_recent=T // 4, min_db=T // 4,
                         sim_threshold=args.sim_threshold,
                         min_inliers=args.min_inliers,
                         ransac_hypotheses=16, consistency_count=3,
                         consistency_window=3)
    return model, variables, lcfg


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--frontend", choices=["sim", "pixels"], default="sim")
    ap.add_argument("--traj", choices=["outback", "pan"], default="outback")
    ap.add_argument("--ensemble", type=int, default=1)
    ap.add_argument("--img-noise", type=float, default=0.02,
                    help="per-frame Gaussian pixel noise (pixels frontend)")
    ap.add_argument("--vss-width", type=int, default=8)
    ap.add_argument("--vss-hw", type=int, nargs=2, default=(48, 64))
    ap.add_argument("--ckpt", default="",
                    help="trained VSS checkpoint (train.restore_checkpoint)")
    ap.add_argument("--min-inliers", type=int, default=10,
                    help="geometric-verify inlier gate. The keypoint "
                         "budget is (H/16)*(W/16) c5 cells, so the gate "
                         "should scale with the input resolution: 10/12 "
                         "at 48x64 is strict, 10/48 at 96x128 passes by "
                         "chance (measured, docs/CALC2_RUN.md r5)")
    ap.add_argument("--sim-threshold", type=float, default=0.9,
                    help="retrieval cosine gate; 0 = AUTO-CALIBRATE per "
                         "run: during the warmup period (db.count < "
                         "min_db, when no genuine revisit can exist yet) "
                         "every query's best-DB similarity is an "
                         "impostor by construction — the gate is set to "
                         "the max of those plus half the remaining gap "
                         "to 1. Descriptor cosine bands are per-model "
                         "(tools/diagnose_loop_threshold.py): a fixed "
                         "0.9 admits every aliased view for some models "
                         "— the reference's fixed 0.85 "
                         "(close_kitti_loops.py:107-109) has the same "
                         "fragility")
    ap.add_argument("--lc-severity", type=float, default=0.0,
                    help="seasonal_change severity applied to the CALC2 "
                         "retrieval input of EVERY frame with an "
                         "independent per-frame field — the cross-season "
                         "stress (DB view and revisit view carry "
                         "different corruptions); the filter's tracking "
                         "input stays clean so the stress isolates the "
                         "retrieval stage (models/augment.py)")
    ap.add_argument("--out", default="runs/loop_demo")
    ap.add_argument("--json", default="")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from ekf_slam_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from ekf_slam_tpu.config import EngineConfig, MapConfig, SimConfig
    from ekf_slam_tpu.filter import engine, loop_fusion
    from ekf_slam_tpu.filter.state import init_state
    from ekf_slam_tpu.models import keypoints as kp_mod
    from ekf_slam_tpu.models import loopclosure as lc
    from ekf_slam_tpu.sim import scene as sim_scene
    from ekf_slam_tpu.utils import trajectory as traj_mod
    from ekf_slam_tpu.utils.checkpoint import dump_trajectory
    from ekf_slam_tpu.vision import frontend

    os.makedirs(args.out, exist_ok=True)
    cfg = EngineConfig(
        map=MapConfig(capacity=48, min_features_in_image=16,
                      max_new_per_step=16),
        sim=SimConfig(num_landmarks=64, depth_min=2.0, depth_max=6.0,
                      pixel_noise_std=1.5))
    T = args.frames

    if args.traj == "pan":
        scn = make_surround_scene(jax.random.key(0), cfg, n_anchors=12)
        xs = pan_trajectory(cfg, T)
    else:
        scn = sim_scene.make_scene(jax.random.key(0), cfg)
        xs = outback_trajectory(cfg, T)

    model, variables, lcfg = build_lc_stack(args, T)

    @jax.jit
    def embed(img):
        outs = model.apply(variables, img[None], train=False,
                           rngs={"reparam": jax.random.key(3)},
                           descriptor_only=True)
        kps = jax.tree.map(lambda a: a[0],
                           kp_mod.kp_descriptor(outs["c5"]))
        return outs["descriptor"][0], kps

    vss_hw = tuple(args.vss_hw)

    def _to_vss(img):
        g = jax.image.resize(img, vss_hw, "linear")
        return jnp.repeat(g[..., None], 3, axis=-1)   # VSS wants RGB
    to_vss = jax.jit(_to_vss)

    if args.lc_severity > 0.0:
        from ekf_slam_tpu.models.augment import seasonal_change

        def _corrupt(img, key):
            return seasonal_change(key, img[None, :, :, None],
                                   args.lc_severity)[0, :, :, 0]
        corrupt = jax.jit(_corrupt)

    render = jax.jit(frontend.render_scene_image,
                     static_argnames="cfg")
    step_sim = jax.jit(engine.step, static_argnames="cfg")
    step_pix = jax.jit(frontend.step_image, static_argnames="cfg")

    # Full-res frames along the true trajectory (deterministic; per-seed
    # sensor noise is added per frame below).
    if args.frontend == "pixels":
        imgs = jnp.stack([render(scn, xs[t], cfg) for t in range(T)])

    def run(seed: int, with_lc: bool):
        """One tracked sequence; returns (traj (T,13), loops, lc_time_s)."""
        import dataclasses
        db = None
        loops, traj = [], []
        lc_time = 0.0
        # --sim-threshold 0: per-run auto-calibration. For a calibration
        # window right after warmup (when the recency exclusion first
        # admits DB entries, but before any plausible genuine revisit),
        # every query's best similarity samples the IMPOSTOR band of
        # this model on this scene; the gate lands halfway between that
        # band's max and 1, and declarations stay masked until the
        # window closes. Assumption (as for any unsupervised novelty
        # calibration): the first genuine revisit happens after
        # min_db * 1.5 frames — true for both trajectories here.
        auto = args.sim_threshold == 0.0
        lcfg_run = lcfg
        imp_max = -1.0
        calib_end = lcfg.min_db + max(lcfg.min_db // 2, 8)
        if args.frontend == "sim":
            obs = jax.vmap(lambda k, x: sim_scene.observe(k, scn, x, cfg))(
                jax.random.split(jax.random.key(1000 + seed), T), xs)
            st = engine.bootstrap(init_state(cfg),
                                  jax.tree.map(lambda a: a[0], obs), cfg)
        else:
            st = init_state(cfg)
            app = frontend.init_appearance(cfg)
        for t in range(T):
            k_t = jax.random.fold_in(jax.random.key(100 + seed), t)
            if args.frontend == "sim":
                o = jax.tree.map(lambda a: a[t], obs)
                st, info = step_sim(st, o, k_t, cfg)
                imgs_t = None
            else:
                imgs_t = imgs[t]
                if args.img_noise > 0:
                    imgs_t = jnp.clip(
                        imgs_t + args.img_noise * jax.random.normal(
                            jax.random.fold_in(
                                jax.random.key(7000 + seed), t),
                            imgs_t.shape), 0.0, 1.0)
                st, app, info = step_pix(st, app, imgs_t, k_t, cfg)
            if with_lc:
                t0 = time.time()
                # CALC2 input: the camera frame itself in pixels mode
                # (the real pipeline); a ground-truth render in sim mode
                # (no pixels exist there).
                src = imgs_t if args.frontend == "pixels" \
                    else render(scn, xs[t], cfg)
                if args.lc_severity > 0.0:
                    src = corrupt(src, jax.random.fold_in(
                        jax.random.key(9000 + seed), t))
                descr, kps = embed(to_vss(src))
                if db is None:
                    db = lc.init_db(lcfg, descr.shape[0], kps.yx.shape[0],
                                    kps.descr.shape[1])
                pose = jnp.concatenate([st.x[0:3], st.x[3:7]])
                n_db = int(db.count)
                warm = n_db >= lcfg.min_db
                if auto and n_db >= calib_end and imp_max > -1.0 \
                        and lcfg_run.sim_threshold == lcfg.sim_threshold:
                    thr = imp_max + (1.0 - imp_max) * 0.5
                    lcfg_run = dataclasses.replace(lcfg,
                                                   sim_threshold=thr)
                    print(f"  seed {seed}: auto sim_threshold {thr:.5f} "
                          f"(impostor max {imp_max:.5f})", flush=True)
                res = lc.query(db, descr, kps, lcfg_run,
                               jax.random.key(200 + t))
                if auto:
                    if warm and n_db < calib_end:
                        s0 = float(res.similarities[0])
                        if np.isfinite(s0):
                            imp_max = max(imp_max, s0)
                    # declarations stay masked until calibrated
                    warm = warm and n_db >= calib_end
                res = res._replace(
                    is_hypothesis=res.is_hypothesis & jnp.asarray(warm))
                db, declared, match_slot, match_frame = lc.step_temporal(
                    db, res, lcfg_run)
                if bool(declared):
                    # 6-DoF pose constraint against the matched frame's
                    # stored pose, noise scaled by verification quality.
                    pose_j = db.pose[int(match_slot)]
                    sp, sr = loop_fusion.loop_noise_sigmas(res.best_inliers)
                    x_new, P_new = loop_fusion.apply_loop_constraint_pose(
                        st.x, st.P, pose_j, sp, sr, jnp.asarray(True))
                    st = st.replace(x=x_new, P=P_new)
                    loops.append((t, int(match_frame)))
                db = lc.push(db, descr, kps, pose)
                lc_time += time.time() - t0
            traj.append(np.asarray(st.x[:13]))
        return np.stack(traj), loops, lc_time

    xs_np = np.asarray(xs)
    rows = []
    for seed in range(args.ensemble):
        t0 = time.time()
        traj_off, _, _ = run(seed, with_lc=False)
        traj_on, loops, lc_s = run(seed, with_lc=True)
        ate_off = float(traj_mod.ate_rmse(jnp.asarray(traj_off[:, 0:3]),
                                          xs[:, 0:3]))
        ate_on = float(traj_mod.ate_rmse(jnp.asarray(traj_on[:, 0:3]),
                                         xs[:, 0:3]))
        fin_off = float(np.linalg.norm(traj_off[-1, 0:3] - xs_np[-1, 0:3]))
        fin_on = float(np.linalg.norm(traj_on[-1, 0:3] - xs_np[-1, 0:3]))
        rows.append({"seed": seed, "ate_off": ate_off, "ate_on": ate_on,
                     "final_off": fin_off, "final_on": fin_on,
                     "loops": loops, "n_loops": len(loops),
                     "wall_s": round(time.time() - t0, 1),
                     "lc_s": round(lc_s, 1)})
        print(f"seed {seed}: ATE off {ate_off:.4f} -> on {ate_on:.4f} "
              f"| final err off {fin_off:.4f} -> on {fin_on:.4f} "
              f"| {len(loops)} loops {loops[:6]}"
              f"{'...' if len(loops) > 6 else ''} "
              f"({rows[-1]['wall_s']}s)", flush=True)
        if seed == 0:
            dump_trajectory(os.path.join(args.out, "trajectory.npz"),
                            traj_on, truth=xs_np)
            dump_trajectory(os.path.join(args.out, "trajectory_nolc.npz"),
                            traj_off, truth=xs_np)

    summary = {
        "frontend": args.frontend, "traj": args.traj, "frames": T,
        "ensemble": args.ensemble, "ckpt": args.ckpt,
        "vss_width": args.vss_width, "img_noise": args.img_noise,
        "lc_severity": args.lc_severity,
        "sim_threshold": args.sim_threshold,
        "ate_off_p50": float(np.median([r["ate_off"] for r in rows])),
        "ate_on_p50": float(np.median([r["ate_on"] for r in rows])),
        "final_off_p50": float(np.median([r["final_off"] for r in rows])),
        "final_on_p50": float(np.median([r["final_on"] for r in rows])),
        "n_loops_total": int(sum(r["n_loops"] for r in rows)),
        "rows": rows,
    }
    print(f"ATE p50: {summary['ate_off_p50']:.4f} without fusion -> "
          f"{summary['ate_on_p50']:.4f} with fusion "
          f"({summary['n_loops_total']} loops over {args.ensemble} seeds)")
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
        print(f"wrote {args.json}")
    print(f"outputs in {args.out}")


if __name__ == "__main__":
    main()
