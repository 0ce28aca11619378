"""Reference-scale VSS train-step compile + timing proof.

The reference trains width-32 (32..512 encoder) on 192x256 crops of
320x320 COCO images at batch 12 for 200k steps ("CALC 2.0"/calc2.py:19-20
vh/vw, :36 width, :43 batch; utils.py:502-507 optimizer). THIS script
proves the full-size model compiles and runs: one jitted train_step at
the exact reference shape, reporting compile time, per-step time, and the
compiled program's memory analysis:

    timeout 1500 python -u tools/vss_fullscale_step.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

from ekf_slam_tpu.data import synthetic_batch, class_weights
from ekf_slam_tpu.models import train as mtrain
from ekf_slam_tpu.models.vss import VSSConfig


def main():
    hw = (192, 256)                     # calc2.py:19-20 (vh, vw)
    batch = 12                          # calc2.py:43
    width = 32                          # calc2.py:36 (encoder 32..512)
    # remat: per-block rematerialization drops the BN/ELU intermediates
    # of the gradient stash (~24 GB at this shape without it; a
    # bit-equivalent update — tests/test_models.py::
    # test_remat_bit_equivalent). Whether an 80 GB card still needs it is
    # open (ROADMAP R7). bfloat16 activations halve the activation stash;
    # state donation lets the output state alias the input buffers.
    remat = os.environ.get("VSS_REMAT", "1") == "1"
    dtype = os.environ.get("VSS_DTYPE", "bfloat16")
    model = mtrain.create_model(VSSConfig(width=width, remat=remat,
                                          compute_dtype=dtype))
    print(f"remat={remat} compute_dtype={dtype}")
    tcfg = mtrain.TrainConfig(batch_size=batch, image_hw=hw)

    t0 = time.time()
    state = mtrain.init_state(model, tcfg, jax.random.key(0))
    n_params = sum(x.size for x in jax.tree.leaves(state.params))
    print(f"init: {time.time()-t0:.1f}s, params {n_params/1e6:.2f}M")

    imgs, labels = synthetic_batch(jax.random.key(1), batch, hw)
    w = class_weights(labels)

    step = jax.jit(lambda s, i, l, ww, k: mtrain.train_step(
        model, tcfg, s, i, l, ww, k), donate_argnums=(0,))
    t0 = time.time()
    lowered = step.lower(state, imgs, labels, w, jax.random.key(2))
    compiled = lowered.compile()
    t_compile = time.time() - t0
    try:
        ma = compiled.memory_analysis()
        print(f"memory analysis: temp {ma.temp_size_in_bytes/2**30:.2f} GiB, "
              f"args {ma.argument_size_in_bytes/2**30:.2f} GiB, "
              f"output {ma.output_size_in_bytes/2**30:.2f} GiB")
    except Exception as e:  # noqa: BLE001 - backend-dependent API
        print(f"memory analysis unavailable: {e}")

    state2, metrics = compiled(state, imgs, labels, w, jax.random.key(2))
    jax.block_until_ready(metrics["loss"])
    t0 = time.time()
    n = 5
    for i in range(n):
        state2, metrics = compiled(state2, imgs, labels, w,
                                   jax.random.key(3 + i))
    loss = float(metrics["loss"])       # scalar fetch closes the timing
    dt = time.time() - t0
    print(f"compile {t_compile:.1f}s; step {dt/n*1000:.1f} ms "
          f"({batch*n/dt:.1f} img/s); loss {loss:.4f} finite="
          f"{bool(jnp.isfinite(metrics['loss']))}")


if __name__ == "__main__":
    main()
