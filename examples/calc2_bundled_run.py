"""CALC2 bundled-data round: shards -> training -> PR-AUC -> loop closure.

The reference trains on COCO-Stuff, evaluates PR on CampusLoopDataset and
closes loops on KITTI ("CALC 2.0"/calc2.py --mode train/pr,
close_kitti_loops.py). None of those datasets can be downloaded in this
environment (zero egress), so this driver runs the SAME protocol end to end
on a deterministic bundled-generator dataset (data/synthetic.py Voronoi
scenes — class-structured layouts with class-correlated appearance):

  1. build npz record shards + dataset-level loss weights
     (records.write_shards — the gen_tfrecords.py equivalent),
  2. train the VSS with the 4-term objective, data-parallel when >1 device
     (train.fit, checkpoints via orbax),
  3. CampusLoop-protocol evaluation: N held-out "places"; memory = clean
     render, live = homography-warped + brightness-shifted view
     (augment.positive_view — the same viewpoint-change model the
     reference trains against); report plain-CALC2 PR-AUC for the TRAINED
     vs UNTRAINED network (retrieval lift) and the G-CALC2 geometric
     re-rank AUC (test_net.py:176-268),
  4. online loop closure over a revisit sequence (close_kitti_loops.py
     protocol via models/loop_runner.run_online): declared-loop precision.

Writes runs/calc2_metrics.json + checkpoint; docs/CALC2_RUN.md records the
numbers.

  python examples/calc2_bundled_run.py --steps 400 --out runs/calc2
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def build_shards(out_dir, n_images, hw, seed=7):
    from ekf_slam_tpu.data import synthetic_batch
    from ekf_slam_tpu.data.records import write_shards

    def pairs():
        k = jax.random.key(seed)
        done = 0
        while done < n_images:
            k, sub = jax.random.split(k)
            imgs, labels = synthetic_batch(sub, 16, hw)
            cls = np.asarray(jnp.argmax(labels, axis=-1)).astype(np.uint8)
            arr = np.asarray(imgs * 255.0).astype(np.uint8)
            for i in range(arr.shape[0]):
                if done >= n_images:
                    return
                yield arr[i], cls[i]
                done += 1

    return write_shards(out_dir, pairs(), shard_size=64)


def eval_places(model, variables, n_places, hw, key, severity=0.0,
                aliasing=0):
    """CampusLoop-style pairs: memory = clean scene render; live = the same
    place through a moderate viewpoint homography + illumination change
    (augment.eval_view — the real-revisit model of test_net.py's pairs;
    mirror flips are a training-only augmentation). severity > 0 adds the
    cross-season appearance model (augment.seasonal_change).

    aliasing > 0 draws the places from `n_places / aliasing` structural
    archetypes (data/synthetic.aliased_places) — the perceptual-aliasing
    regime where independent-scene retrieval saturates (docs/CALC2_RUN.md);
    adds same-archetype-impostor similarity stats to the result."""
    from ekf_slam_tpu.data import synthetic_batch
    from ekf_slam_tpu.data.synthetic import aliased_places
    from ekf_slam_tpu.models import augment, evaluate

    if aliasing:
        mem, _, arch = aliased_places(jax.random.key(1234), n_places,
                                      group=aliasing, hw=hw)
    else:
        mem, _ = synthetic_batch(jax.random.key(1234), n_places, hw)
        arch = None
    live = augment.eval_view(key, mem, severity=severity)
    out = evaluate.evaluate_pairs(model, variables, live, mem, batch=8)
    if arch is not None:
        sim = np.asarray(out["similarity"])
        a = np.asarray(arch)
        eye = np.eye(n_places, dtype=bool)
        same_arch = (a[:, None] == a[None, :]) & ~eye
        cross = (a[:, None] != a[None, :])
        out["true_revisit_p50"] = float(np.median(np.diag(sim)))
        out["aliased_impostor_p50"] = float(np.median(sim[same_arch]))
        out["aliased_impostor_p99"] = float(
            np.percentile(sim[same_arch], 99))
        out["cross_arch_impostor_p99"] = float(
            np.percentile(sim[cross], 99))
    return out, live, mem


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--width", type=int, default=16)
    ap.add_argument("--hw", type=int, nargs=2, default=(96, 128))
    ap.add_argument("--data-hw", type=int, nargs=2, default=None,
                    help="shard-image size when larger than --hw: the "
                         "reference writes 320x320 shards and random-"
                         "crops each training batch to vh x vw inside "
                         "the step (gen_tfrecords.py / calc2.py:254-258;"
                         " train_step crops when shapes differ). Eval "
                         "places stay at --hw. Default: same as --hw "
                         "(no crop).")
    ap.add_argument("--images", type=int, default=1024)
    ap.add_argument("--places", type=int, default=64)
    ap.add_argument("--out", default="runs/calc2")
    ap.add_argument("--eval-severity", type=float, default=0.0,
                    help="cross-season appearance severity for the eval "
                         "pairs (augment.seasonal_change; 0 = off)")
    ap.add_argument("--aliasing", type=int, default=0,
                    help="perceptual-aliasing group size: draw the eval "
                         "places from places/aliasing structural "
                         "archetypes (0 = independent scenes)")
    ap.add_argument("--aliasing-sweep", default="",
                    help="comma list of aliasing group sizes to re-eval "
                         "the trained model at (difficulty curve), e.g. "
                         "'2,4,8,16'")
    ap.add_argument("--train-aliasing", type=int, default=0,
                    help="train on archetype-GROUPED batches of this "
                         "group size (data/synthetic.aliased_batches) so "
                         "in-batch hard-negative mining sees aliased "
                         "siblings — the fix for the r2run4 regression "
                         "where independent-scene training made plain "
                         "retrieval worse under aliasing (0 = off, "
                         "train on independent-scene shards)")
    ap.add_argument("--sim-objective", default="triplet",
                    choices=["triplet", "infonce"],
                    help="similarity objective: reference triplet "
                         "(calc2.py:276-279) or temperature-scaled "
                         "InfoNCE (losses.infonce_loss — for the "
                         "aliasing regime where the 0.5-margin hinge "
                         "is unsatisfiable and stays pinned, runs/r3f)")
    ap.add_argument("--sim-tau", type=float, default=0.01)
    ap.add_argument("--train-severity", type=float, default=0.0,
                    help="appearance-severity augmentation on the "
                         "positive training view (TrainConfig."
                         "aug_severity — seasonal_change applied at "
                         "this severity; trains invariance to the "
                         "appearance model the severity evals probe)")
    ap.add_argument("--remat", action="store_true",
                    help="per-block gradient rematerialization "
                         "(VSSConfig.remat — required for the reference "
                         "training shape on a 16 GB chip, bit-equivalent "
                         "update)")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="activation compute dtype (params stay f32)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from ekf_slam_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from jax.sharding import Mesh
    from ekf_slam_tpu.data.records import ShardReader, load_weights
    from ekf_slam_tpu.models import evaluate, keypoints as kp_mod
    from ekf_slam_tpu.models import loopclosure as lc
    from ekf_slam_tpu.models import loop_runner, train
    from ekf_slam_tpu.models.vss import VSSConfig
    from ekf_slam_tpu.utils import MetricsLogger

    os.makedirs(args.out, exist_ok=True)
    hw = tuple(args.hw)
    data_hw = tuple(args.data_hw) if args.data_hw else hw
    assert data_hw[0] >= hw[0] and data_hw[1] >= hw[1], \
        "--data-hw must be >= --hw (shards are cropped down, not up)"
    data_dir = os.path.join(args.out, "shards")
    t0 = time.time()
    if not args.train_aliasing and not os.path.exists(
            os.path.join(data_dir, "loss_weights.txt")):
        n_shards = build_shards(data_dir, args.images, data_hw)
        print(f"wrote {n_shards} shards ({args.images} images at "
              f"{data_hw[0]}x{data_hw[1]}) in {time.time()-t0:.0f}s")

    model = train.create_model(VSSConfig(width=args.width, remat=args.remat,
                                         compute_dtype=args.dtype))
    tcfg = train.TrainConfig(batch_size=args.batch, image_hw=hw,
                             ckpt_every=max(args.steps // 2, 1),
                             sim_objective=args.sim_objective,
                             sim_tau=args.sim_tau,
                             aug_severity=args.train_severity)
    # Untrained baseline first (same init seed as training).
    state0 = train.init_state(model, tcfg, jax.random.key(tcfg.seed))
    vars0 = {"params": state0.params, "batch_stats": state0.batch_stats}
    base_eval, live, mem = eval_places(
        model, vars0, args.places, hw, jax.random.key(5),
        severity=args.eval_severity, aliasing=args.aliasing)
    print(f"UNTRAINED PR-AUC: {base_eval['auc']:.4f}")

    n_dev = jax.device_count()
    mesh = Mesh(np.array(jax.devices()), ("data",)) \
        if n_dev > 1 and args.batch % n_dev == 0 else None
    logger = MetricsLogger()
    t0 = time.time()
    if args.train_aliasing:
        from ekf_slam_tpu.data import aliased_batches
        batches = aliased_batches(jax.random.key(99), args.batch,
                                  group=args.train_aliasing, hw=hw)
        fit_data_dir = None     # per-batch class-weight estimation
    else:
        batches = ShardReader(data_dir, args.batch)
        fit_data_dir = data_dir
    state, metrics = train.fit(
        model, tcfg, batches, args.steps,
        mesh=mesh, ckpt_dir=args.out, logger=logger,
        data_dir=fit_data_dir)
    train_s = time.time() - t0
    logger.dump_jsonl(os.path.join(args.out, "train_metrics.jsonl"))
    print(logger.table(last_n=3))
    print(f"trained {args.steps} steps in {train_s:.0f}s "
          f"({args.steps/max(train_s,1e-9):.1f} steps/s)")

    variables = {"params": state.params, "batch_stats": state.batch_stats}
    trained_eval, _, _ = eval_places(
        model, variables, args.places, hw, jax.random.key(5),
        severity=args.eval_severity, aliasing=args.aliasing)
    for k in ("true_revisit_p50", "aliased_impostor_p50",
              "aliased_impostor_p99", "cross_arch_impostor_p99"):
        if k in trained_eval:
            print(f"  {k}: untrained {base_eval[k]:.4f} "
                  f"-> trained {trained_eval[k]:.4f}")
    print(f"TRAINED PR-AUC: {trained_eval['auc']:.4f} "
          f"(lift {trained_eval['auc'] - base_eval['auc']:+.4f})")

    # G-CALC2 re-rank (test_net.py:176-206).
    from ekf_slam_tpu.models import evaluate as _ev

    @jax.jit
    def embed_kp(imgs):
        outs = model.apply(variables, imgs, train=False,
                           rngs={"reparam": jax.random.key(0)},
                           descriptor_only=True)
        return outs["descriptor"], kp_mod.kp_descriptor(outs["c5"])

    def batched_embed(imgs):
        ds, kps = [], []
        for i in range(0, imgs.shape[0], 8):
            d, k = embed_kp(imgs[i:i + 8])
            ds.append(d)
            kps.append(k)
        return (jnp.concatenate(ds),
                jax.tree.map(lambda *a: jnp.concatenate(a), *kps))

    def gcalc2_auc(live_i, mem_i, key):
        d_l, kp_l = batched_embed(live_i)
        d_m, kp_m = batched_embed(mem_i)
        lcfg_i = lc.LoopConfig(min_inliers=10, ransac_hypotheses=16)
        gl, gs = _ev.geometric_rerank(d_l, kp_l, d_m, kp_m, lcfg_i,
                                      key, top_k=5)
        return _ev.pr_auc(gl, gs)

    g_auc = gcalc2_auc(live, mem, jax.random.key(9))
    print(f"G-CALC2 re-rank PR-AUC: {g_auc:.4f}")

    # Online loop closure on a revisit sequence (close_kitti_loops.py
    # protocol): first pass through P places, then revisit them (warped).
    # The similarity gate is CALIBRATED on the held-out eval pairs — the
    # PR-curve operating-point analysis of test_net.py in automated form:
    # pick the retrieval-score threshold maximizing F1 over the held-out
    # places (scores are top-1 sims in the (1+cos)/2 scale; the loop DB
    # gates on raw cosine). The geometric verify + temporal-consistency
    # stages (close_kitti_loops.py:113-138) then handle the impostors
    # this recall-oriented gate admits.
    labels = np.asarray(trained_eval["labels"])
    scores = np.asarray(trained_eval["scores"])
    order = np.argsort(-scores)
    tp = np.cumsum(labels[order])
    k = np.arange(1, len(order) + 1)
    f1 = 2.0 * tp / (k + labels.sum())
    thr = float(2.0 * scores[order][np.argmax(f1)] - 1.0)  # -> cosine
    cos = 2.0 * np.asarray(trained_eval["similarity"]) - 1.0
    true_cos = np.diag(cos)
    imp_cos = cos[~np.eye(cos.shape[0], dtype=bool)]
    print(f"calibrated loop sim_threshold: {thr:.3f} (max-F1 point; "
          f"true med {np.median(true_cos):.3f}, "
          f"impostor p99 {np.percentile(imp_cos, 99.0):.3f})")
    P = min(24, args.places)
    seq = jnp.concatenate([mem[:P], live[:P]], axis=0)
    lcfg2 = lc.LoopConfig(capacity=128, top_k=3, exclude_recent=P // 2,
                          min_db=P // 2, sim_threshold=thr, min_inliers=8,
                          ransac_hypotheses=16, consistency_count=2,
                          consistency_window=2)
    x0 = jnp.zeros(13).at[3].set(1.0)
    P0 = jnp.eye(13) * 1e-2
    db, xf, Pf, outs = loop_runner.run_online(
        model, variables, seq, x0, P0, lcfg2, jax.random.key(11))
    declared = np.asarray(outs.declared)
    match = np.asarray(outs.match_id)
    # A declared loop at revisit step P+i is correct if it matched frame
    # within the consistency window of i.
    correct = 0
    for t in np.flatnonzero(declared):
        if t >= P and abs(int(match[t]) - (t - P)) <= 3:
            correct += 1
    n_declared = int(declared.sum())
    print(f"loops declared on revisit pass: {n_declared} "
          f"({correct} correct)")

    # Aliasing difficulty curve (--aliasing-sweep "2,4,8,16"): re-run the
    # place eval at several archetype group sizes with the SAME trained
    # weights. The r2run4 single point showed plain retrieval collapsing
    # under aliasing while the G-CALC2 geometric re-rank carries the
    # system (test_net.py's retrieval-proposes/geometry-disposes split);
    # the sweep turns that into a curve: auc(group) for plain vs re-rank.
    sweep_rows = []
    for g in ([int(s) for s in args.aliasing_sweep.split(",") if s]
              if args.aliasing_sweep else []):
        ev_u, _, _ = eval_places(model, vars0, args.places, hw,
                                 jax.random.key(5),
                                 severity=args.eval_severity, aliasing=g)
        ev_t, live_g, mem_g = eval_places(model, variables, args.places,
                                          hw, jax.random.key(5),
                                          severity=args.eval_severity,
                                          aliasing=g)
        gr = gcalc2_auc(live_g, mem_g, jax.random.key(9))
        row = {"group": g, "pr_auc_untrained": float(ev_u["auc"]),
               "pr_auc_trained": float(ev_t["auc"]),
               "pr_auc_gcalc2": float(gr)}
        for k in ("true_revisit_p50", "aliased_impostor_p50",
                  "cross_arch_impostor_p99"):
            if k in ev_t:
                row[k] = ev_t[k]
        sweep_rows.append(row)
        print(f"aliasing group {g}: plain {row['pr_auc_trained']:.4f} "
              f"(untrained {row['pr_auc_untrained']:.4f}), "
              f"G-CALC2 {row['pr_auc_gcalc2']:.4f}")

    train.save_checkpoint(
        os.path.abspath(os.path.join(args.out, "ckpt_final")), state)
    results = {
        "steps": args.steps, "width": args.width, "hw": list(hw),
        "images": args.images, "places": args.places,
        "loss_first": (logger.series("loss")[0]
                       if logger.series("loss") else None),
        "loss_last": (logger.series("loss")[-1]
                      if logger.series("loss") else None),
        "pr_auc_untrained": float(base_eval["auc"]),
        "pr_auc_trained": float(trained_eval["auc"]),
        "pr_auc_gcalc2": float(g_auc),
        "loops_declared": n_declared, "loops_correct": correct,
        "loop_sim_threshold": thr,
        "eval_severity": args.eval_severity,
        "aliasing": args.aliasing,
        "train_aliasing": args.train_aliasing,
        "train_severity": args.train_severity,
        "sim_objective": args.sim_objective,
        "sim_tau": args.sim_tau,
        "aliasing_sweep": sweep_rows,
        "train_steps_per_s": args.steps / max(train_s, 1e-9),
        "class_weights": (load_weights(data_dir).tolist()
                          if not args.train_aliasing else None),
    }
    for k in ("true_revisit_p50", "aliased_impostor_p50",
              "aliased_impostor_p99", "cross_arch_impostor_p99"):
        if k in trained_eval:
            results[k + "_untrained"] = base_eval[k]
            results[k] = trained_eval[k]
    with open(os.path.join(args.out, "calc2_metrics.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps({k: v for k, v in results.items()
                      if k != "class_weights"}, indent=2))


if __name__ == "__main__":
    main()
