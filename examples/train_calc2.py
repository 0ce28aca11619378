"""CALC2 training driver — the `calc2.py --mode train` equivalent.

Trains the VSS loop-closure network on synthetic scenes (or npz record
shards via --data), data-parallel over all local devices, with periodic
checkpointing and a PR evaluation at the end.

  python examples/train_calc2.py --steps 200 --batch 8 --width 16 \
      --out /tmp/calc2_run
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--width", type=int, default=16)
    ap.add_argument("--hw", type=int, nargs=2, default=(64, 64))
    ap.add_argument("--data", default=None, help="npz shard dir (records.py)")
    ap.add_argument("--out", default="/tmp/calc2_run")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from ekf_slam_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from jax.sharding import Mesh
    from ekf_slam_tpu.data import synthetic_batch
    from ekf_slam_tpu.models import evaluate, train
    from ekf_slam_tpu.models.vss import VSSConfig
    from ekf_slam_tpu.utils import MetricsLogger

    os.makedirs(args.out, exist_ok=True)
    hw = tuple(args.hw)
    model = train.create_model(VSSConfig(width=args.width))
    tcfg = train.TrainConfig(batch_size=args.batch, image_hw=hw,
                             ckpt_every=args.ckpt_every)

    if args.data:
        from ekf_slam_tpu.data.records import ShardReader
        batches = iter(ShardReader(args.data, args.batch))
    else:
        def synth():
            k = jax.random.key(1)
            while True:
                k, sub = jax.random.split(k)
                yield synthetic_batch(sub, args.batch, hw)
        batches = synth()

    n_dev = jax.device_count()
    mesh = Mesh(np.array(jax.devices()), ("data",)) \
        if n_dev > 1 and args.batch % n_dev == 0 else None
    logger = MetricsLogger()
    state, metrics = train.fit(
        model, tcfg, batches, args.steps, mesh=mesh,
        ckpt_dir=args.out, logger=logger)
    logger.dump_jsonl(os.path.join(args.out, "train_metrics.jsonl"))
    print(logger.table(last_n=3))

    # PR evaluation on near-duplicate pairs (the --mode pr protocol).
    mem, _ = synthetic_batch(jax.random.key(99), 8, hw)
    live = jnp.clip(mem + 0.02 * jax.random.normal(jax.random.key(100),
                                                   mem.shape), 0, 1)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    out = evaluate.evaluate_pairs(model, variables, live, mem, batch=4)
    print(f"retrieval PR-AUC: {out['auc']:.4f}")
    train.save_checkpoint(os.path.join(args.out, "ckpt_final"), state)
    print(f"outputs in {args.out}")


if __name__ == "__main__":
    main()
