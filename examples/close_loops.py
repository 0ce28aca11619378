"""Online loop closure from files on disk — the close_kitti_loops.py analog.

The reference's entry point reads a KITTI-format VO pose file and an image
directory, runs CALC2 per frame (descriptor + local keypoints), queries the
growing database with a temporal-consistency filter, and writes three text
artifacts ("CALC 2.0"/close_kitti_loops.py:60-158): kitti_traj.txt (poses),
kitti_loops.txt (both poses of each declared loop — constraints nothing
consumes), kitti_q_times.txt (query time vs db size). This script does the
same against this framework's stack (models/loopclosure.py ring DB +
geometric verify + temporal filter), consuming:

  --poses   KITTI 12-float rows (io/poses.load_kitti_poses)
  --pattern printf image pattern, loaded through the native C++ batch
            loader (io/sequence.ImageSequence / native/imageio.cpp)

and writing the same three artifacts (loops rows carry BOTH full poses, so
a consumer can feed filter/loop_fusion.apply_loop_constraint_pose — the
link the reference leaves open, SURVEY.md §1).

  python examples/close_loops.py --poses seq/poses.txt \
      --pattern 'seq/%06d.pgm' --frames 20 --out /tmp/loops --cpu
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--poses", required=True)
    ap.add_argument("--pattern", required=True)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--frames", type=int, default=0,
                    help="0 = as many as the pose file has")
    ap.add_argument("--out", default="/tmp/loops")
    ap.add_argument("--vss-width", type=int, default=8)
    ap.add_argument("--vss-hw", type=int, nargs=2, default=(48, 64))
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--sim-threshold", type=float, default=0.85)
    ap.add_argument("--min-inliers", type=int, default=8)
    ap.add_argument("--consistency", type=int, nargs=2, default=(2, 3),
                    help="C hits within window W (reference: 7 9)")
    ap.add_argument("--exclude-recent", type=int, default=0,
                    help="0 = frames//4 (reference: 200)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--plot", action="store_true",
                    help="also write loops.png — the plot_loops.m analog "
                         "(trajectory polyline + red loop chords)")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from ekf_slam_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from ekf_slam_tpu.io import ImageSequence
    from ekf_slam_tpu.io.poses import (load_kitti_poses, poses_to_rq,
                                       save_trajectory_kitti)
    from ekf_slam_tpu.models import keypoints as kp_mod
    from ekf_slam_tpu.models import loopclosure as lc
    from ekf_slam_tpu.models import train
    from ekf_slam_tpu.models.vss import VSSConfig

    poses = load_kitti_poses(args.poses)
    T = args.frames or poses.shape[0]
    assert poses.shape[0] >= T, \
        f"pose file has {poses.shape[0]} rows < --frames {T}"
    poses_rq = poses_to_rq(poses[:T])
    seq = ImageSequence(args.pattern, args.start, T)

    model = train.create_model(VSSConfig(width=args.vss_width))
    tcfg = train.TrainConfig(batch_size=2, image_hw=tuple(args.vss_hw))
    tstate = train.init_state(model, tcfg, jax.random.key(2))
    if args.ckpt:
        tstate = train.restore_checkpoint(args.ckpt, tstate)
    variables = {"params": tstate.params, "batch_stats": tstate.batch_stats}

    excl = args.exclude_recent or max(T // 4, 2)
    lcfg = lc.LoopConfig(capacity=max(256, T), top_k=3,
                         exclude_recent=excl, min_db=excl,
                         sim_threshold=args.sim_threshold,
                         min_inliers=args.min_inliers,
                         ransac_hypotheses=16,
                         consistency_count=args.consistency[0],
                         consistency_window=args.consistency[1])

    vss_hw = tuple(args.vss_hw)

    @jax.jit
    def embed(img):
        g = jax.image.resize(img, vss_hw, "linear")
        rgb = jnp.repeat(g[..., None], 3, axis=-1)
        outs = model.apply(variables, rgb[None], train=False,
                           rngs={"reparam": jax.random.key(3)},
                           descriptor_only=True)
        kps = jax.tree.map(lambda a: a[0], kp_mod.kp_descriptor(outs["c5"]))
        return outs["descriptor"][0], kps

    os.makedirs(args.out, exist_ok=True)
    db = None
    loops = []       # (i, j, pose_i(7), pose_j(7))
    q_times = []     # (frame, db_count, seconds)
    for t in range(T):
        img = jnp.asarray(seq.load(t, 1)[0])
        descr, kps = embed(img)
        if db is None:
            db = lc.init_db(lcfg, descr.shape[0], kps.yx.shape[0],
                            kps.descr.shape[1])
        t0 = time.perf_counter()
        warm = int(db.count) >= lcfg.min_db
        res = lc.query(db, descr, kps, lcfg, jax.random.key(200 + t))
        res = res._replace(
            is_hypothesis=res.is_hypothesis & jnp.asarray(warm))
        db, declared, match_slot, match_frame = lc.step_temporal(
            db, res, lcfg)
        jax.block_until_ready(declared)
        q_times.append((t, int(db.count), time.perf_counter() - t0))
        if bool(declared):
            j = int(match_frame)
            loops.append((t, j, poses_rq[t], poses_rq[j]))
            print(f"LOOP frame {t} -> {j} "
                  f"(inliers {int(res.best_inliers)})", flush=True)
        db = lc.push(db, descr, kps, jnp.asarray(poses_rq[t]))
    seq.close()

    # The three close_kitti_loops.py artifacts (:141-158).
    save_trajectory_kitti(os.path.join(args.out, "kitti_traj.txt"),
                          poses_rq)
    with open(os.path.join(args.out, "kitti_loops.txt"), "w") as f:
        for i, j, pi, pj in loops:
            row = [i, j] + [float(v) for v in pi] + [float(v) for v in pj]
            f.write(" ".join(str(v) for v in row) + "\n")
    with open(os.path.join(args.out, "kitti_q_times.txt"), "w") as f:
        for t, n, dt in q_times:
            f.write(f"{t} {n} {dt:.6f}\n")
    print(f"{len(loops)} loops over {T} frames; artifacts in {args.out}")
    if args.plot:
        from ekf_slam_tpu.viz import plot_loops
        plot_loops(os.path.join(args.out, "loops.png"),
                   os.path.join(args.out, "kitti_traj.txt"),
                   os.path.join(args.out, "kitti_loops.txt"))
        print(f"wrote {os.path.join(args.out, 'loops.png')}")


if __name__ == "__main__":
    main()
