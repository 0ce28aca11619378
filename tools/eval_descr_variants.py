"""Untrained A/B of the VSS descriptor-head variants under perceptual
aliasing (VSSConfig.descr_source / descr_intra_norm).

Rationale (docs/CALC2_RUN.md r3): at aliasing group 4+ the reference's
H/16 NetVLAD-pooled descriptor compresses same-archetype cosines into a
~1e-4 band, so no training objective can buy back separation — the fix
has to be architectural. Because the UNTRAINED descriptor already ranks
at PR-AUC 0.7+ (random conv features are a usable pooled representation),
a cheap untrained A/B of the head variants directly measures each head's
separation CEILING before committing a training run to the winner.

Runs on CPU by default (forward-only, tiny model); --gpu opts in.

Protocol mirrors examples/calc2_bundled_run.eval_places: memory = clean
aliased_places render, live = eval_view homography+illumination revisit,
PR over nearest-neighbor retrieval (test_net.py:169,255-268).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

if "--gpu" not in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

VARIANTS = {
    "d5": {},                                      # reference parity
    "d5_nointra": {"descr_intra_norm": False},
    "d4": {"descr_source": "d4"},
    "d4_nointra": {"descr_source": "d4", "descr_intra_norm": False},
    "multi": {"descr_source": "multi"},
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=32)
    ap.add_argument("--hw", type=int, nargs=2, default=(96, 128))
    ap.add_argument("--places", type=int, default=64)
    ap.add_argument("--aliasing", default="4,16")
    ap.add_argument("--severity", type=float, default=0.0)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", default="runs/descr_variants.json")
    ap.add_argument("--gpu", action="store_true")
    args = ap.parse_args()

    from ekf_slam_tpu.data.synthetic import aliased_places
    from ekf_slam_tpu.models import augment, evaluate, train
    from ekf_slam_tpu.models.vss import VSSConfig

    hw = tuple(args.hw)
    groups = [int(g) for g in args.aliasing.split(",") if g]
    tcfg = train.TrainConfig(batch_size=2, image_hw=hw)
    rows = []
    for name in args.variants.split(","):
        kw = VARIANTS[name]
        model = train.create_model(VSSConfig(width=args.width, **kw))
        state = train.init_state(model, tcfg, jax.random.key(tcfg.seed))
        variables = {"params": state.params,
                     "batch_stats": state.batch_stats}
        for g in groups:
            t0 = time.time()
            mem, _, arch = aliased_places(jax.random.key(1234),
                                          args.places, group=g, hw=hw)
            live = augment.eval_view(jax.random.key(5), mem,
                                     severity=args.severity)
            out = evaluate.evaluate_pairs(model, variables, live, mem,
                                          batch=8)
            sim = np.asarray(out["similarity"])
            a = np.asarray(arch)
            eye = np.eye(args.places, dtype=bool)
            same = (a[:, None] == a[None, :]) & ~eye
            row = {
                "variant": name, "group": g,
                "pr_auc": float(out["auc"]),
                "true_p50": float(np.median(np.diag(sim))),
                "sib_p50": float(np.median(sim[same])),
                "sib_p99": float(np.percentile(sim[same], 99)),
                "cross_p99": float(np.percentile(
                    sim[a[:, None] != a[None, :]], 99)),
                "eval_s": round(time.time() - t0, 1),
            }
            # The quantity training must exploit: how far the true
            # revisit sits above the median sibling impostor.
            row["margin_p50"] = row["true_p50"] - row["sib_p50"]
            rows.append(row)
            print(f"{name:12s} g={g:2d} PR-AUC {row['pr_auc']:.4f} "
                  f"true_p50 {row['true_p50']:.4f} "
                  f"sib_p50 {row['sib_p50']:.4f} "
                  f"margin {row['margin_p50']:+.4f} "
                  f"sib_p99 {row['sib_p99']:.4f} "
                  f"({row['eval_s']:.0f}s)", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"width": args.width, "hw": list(hw),
                   "places": args.places, "severity": args.severity,
                   "rows": rows}, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
