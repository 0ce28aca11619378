"""CALC2 training: optax step + data-parallel mesh sharding.

The reference trains with tf.estimator + MirroredStrategy over local GPUs
(utils.py:526-588: Adam(1e-3), global-norm gradient clip 5, checkpoint every
1024 steps). Redesign:

* one pure `train_step(state, batch, rng)` jitted over a
  jax.sharding.Mesh — batch sharded over the 'data' axis, parameters
  replicated; XLA inserts the gradient all-reduce over the interconnect
  (the
  MirroredStrategy equivalent, SURVEY.md §2.8).
* NaN guards on every loss term mirror tf.check_numerics (calc2.py:311-313)
  via `debug_nans`-free explicit checks in `metrics`.
* Orbax checkpointing (every `ckpt_every` steps, keep-all like the
  reference's RunConfig utils.py:563-566).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ekf_slam_tpu.models import augment, losses
from ekf_slam_tpu.models.vss import VSS, VSSConfig
from ekf_slam_tpu.utils import pytree


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-3     # utils.py:502 Adam
    grad_clip: float = 5.0          # utils.py:505 clip_gradients
    batch_size: int = 12            # calc2.py:43
    image_hw: tuple = (192, 256)    # calc2.py:19-20 (vh, vw)
    margin: float = 0.5             # calc2.py:278
    # "triplet" = reference parity; "infonce" = temperature-scaled
    # contrastive for the aliasing regime (losses.infonce_loss rationale).
    sim_objective: str = "triplet"
    sim_tau: float = 0.01
    # Appearance-severity augmentation on the positive view
    # (augment.seasonal_change at this severity, 0 = off). The reference
    # gets cross-season invariance from its data (CampusLoop pairs are
    # cross-season; COCO training spans appearance); the bundled
    # synthetic world models it explicitly — training without it leaves
    # the descriptor brittle to appearance change the untrained net
    # shrugs off (docs/CALC2_RUN.md r3 severity sweep).
    aug_severity: float = 0.0
    ckpt_every: int = 1024          # utils.py:563
    seed: int = 0


@pytree.dataclass
class TrainState:
    params: Any
    batch_stats: Any
    opt_state: Any
    step: jnp.ndarray


def create_model(cfg: Optional[VSSConfig] = None) -> VSS:
    return VSS(cfg or VSSConfig())


def init_state(model: VSS, tcfg: TrainConfig, rng: jax.Array) -> TrainState:
    h, w = tcfg.image_hw
    dummy = jnp.zeros((1, h, w, 3), jnp.float32)
    variables = model.init({"params": rng, "reparam": rng}, dummy, train=False)
    tx = make_optimizer(tcfg)
    return TrainState(
        params=variables["params"],
        batch_stats=variables.get("batch_stats", {}),
        opt_state=tx.init(variables["params"]),
        step=jnp.zeros((), jnp.int32))


def make_optimizer(tcfg: TrainConfig) -> optax.GradientTransformation:
    return optax.chain(
        optax.clip_by_global_norm(tcfg.grad_clip),
        optax.adam(tcfg.learning_rate))


def train_step(model: VSS, tcfg: TrainConfig, state: TrainState,
               images: jnp.ndarray, labels_onehot: jnp.ndarray,
               class_weights: jnp.ndarray, rng: jax.Array):
    """One optimization step. images: (B,H,W,3) in [0,1]; labels_onehot:
    (B,H,W,13); class_weights: (13,). Returns (new_state, metrics).

    When the incoming batch is LARGER than tcfg.image_hw, it is randomly
    cropped to image_hw first — the reference trains the 192x256 network
    on random crops of its 320x320 shard images (calc2.py:254-258); the
    shapes stay static under jit because both sizes are."""
    # aug_severity == 0 keeps the original 4-way split so default runs
    # stay bit-reproducible against earlier rounds.
    if tcfg.aug_severity > 0.0:
        k_crop, k_aug, k_sev, k_rep1, k_rep2 = jax.random.split(rng, 5)
    else:
        k_crop, k_aug, k_rep1, k_rep2 = jax.random.split(rng, 4)
        k_sev = None
    if images.shape[1:3] != tuple(tcfg.image_hw):
        images, labels_onehot = augment.random_crop(
            k_crop, images, labels_onehot, tcfg.image_hw)
    im_warp = augment.positive_view(k_aug, images)
    if tcfg.aug_severity > 0.0:
        im_warp = augment.seasonal_change(k_sev, im_warp,
                                          severity=tcfg.aug_severity)
    tx = make_optimizer(tcfg)

    def loss_fn(params):
        variables = {"params": params, "batch_stats": state.batch_stats}
        outs, mut = model.apply(
            variables, images, train=True, mutable=["batch_stats"],
            rngs={"reparam": k_rep1})
        outs_p = model.apply(
            {"params": params, "batch_stats": mut["batch_stats"]},
            im_warp, train=True, mutable=["batch_stats"],
            rngs={"reparam": k_rep2}, descriptor_only=True)[0]
        loss, metrics = losses.total_loss(
            outs, outs_p["descriptor"], images, labels_onehot, class_weights,
            tcfg.margin, sim_objective=tcfg.sim_objective,
            sim_tau=tcfg.sim_tau)
        return loss, (metrics, mut["batch_stats"])

    grads, (metrics, new_bs) = jax.grad(loss_fn, has_aux=True)(state.params)
    updates, new_opt = tx.update(grads, state.opt_state, state.params)
    new_params = optax.apply_updates(state.params, updates)
    metrics["grad_norm"] = optax.global_norm(grads)
    return TrainState(params=new_params, batch_stats=new_bs,
                      opt_state=new_opt, step=state.step + 1), metrics


def make_sharded_train_step(model: VSS, tcfg: TrainConfig, mesh: Mesh):
    """jit the train step over a ('data',) mesh: batch sharded on 'data',
    state replicated. XLA inserts the psum over the interconnect for the
    grads — the
    MirroredStrategy all-reduce equivalent."""
    data = NamedSharding(mesh, P("data"))
    repl = NamedSharding(mesh, P())

    def step_fn(state, images, labels, weights, rng):
        images = jax.lax.with_sharding_constraint(images, data)
        labels = jax.lax.with_sharding_constraint(labels, data)
        return train_step(model, tcfg, state, images, labels, weights, rng)

    return jax.jit(
        step_fn,
        in_shardings=(repl, data, data, repl, repl),
        out_shardings=(repl, repl))


def fit(model: VSS, tcfg: TrainConfig, batches, num_steps: int,
        mesh: Optional[Mesh] = None, eval_fn=None, ckpt_dir=None,
        logger=None, rng=None, class_weights=None, data_dir=None):
    """Training loop — the utils.train_and_eval equivalent (utils.py:526-588):
    Adam + clip, checkpoint every tcfg.ckpt_every steps (keep-all), optional
    eval callback, console/metrics logging.

    batches: iterator of (images, labels_onehot); cycled if exhausted.
    class_weights: (13,) dataset-level inverse class frequencies (the
    reference precomputes these over the whole corpus as loss_weights.txt,
    gen_tfrecords.py:104-105,162-167 — records.load_weights reads our
    equivalent). Defaults to load_weights(data_dir) when data_dir is given;
    only without either does it fall back to noisy per-batch estimation
    (appropriate for the synthetic generator, where batch statistics ARE
    the dataset statistics).
    """
    import itertools
    import os as _os

    rng = jax.random.key(tcfg.seed) if rng is None else rng
    state = init_state(model, tcfg, rng)
    if mesh is not None:
        step_fn = make_sharded_train_step(model, tcfg, mesh)
    else:
        step_fn = jax.jit(lambda s, i, l, w, r: train_step(
            model, tcfg, s, i, l, w, r))
    if class_weights is None and data_dir is not None:
        from ekf_slam_tpu.data import records
        class_weights = records.load_weights(data_dir)
    if class_weights is not None:
        class_weights = jnp.asarray(class_weights, jnp.float32)
    if hasattr(batches, "__next__"):
        it = batches                       # already an iterator
    else:
        # re-iterable (list, ShardReader, ...): loop epochs, re-invoking
        # __iter__ so epoch-shuffling loaders re-shuffle.
        it = itertools.chain.from_iterable(itertools.repeat(batches))
    import time as _time

    metrics = {}
    t_fit = _time.time()
    for step_i in range(num_steps):
        images, labels = next(it)
        images = jnp.asarray(images)
        labels = jnp.asarray(labels)
        if class_weights is not None:
            w = class_weights
        else:
            w = jnp.asarray(1.0 / jnp.maximum(
                jnp.mean(labels, axis=(0, 1, 2)), 1e-3))
        rng, k = jax.random.split(rng)
        if step_i == 0:
            # Heartbeat for detached runs: the first call compiles the
            # train step — mark the compile start so a log watcher can
            # tell a long compile from a stuck run.
            print(f"[fit] compiling train step "
                  f"(b={tcfg.batch_size}, hw={tcfg.image_hw})...",
                  flush=True)
        state, metrics = step_fn(state, images, labels, w, k)
        if logger is not None:
            logger.log(step_i, **{k_: float(v) for k_, v in metrics.items()})
            if step_i == 0 or (step_i + 1) % 50 == 0 \
                    or step_i + 1 == num_steps:
                el = _time.time() - t_fit
                print(f"[fit] step {step_i + 1}/{num_steps} "
                      f"loss={float(metrics['loss']):.4f} "
                      f"{el:.0f}s elapsed", flush=True)
        if ckpt_dir and (step_i + 1) % tcfg.ckpt_every == 0:
            save_checkpoint(
                _os.path.join(ckpt_dir, f"ckpt_{step_i + 1:07d}"), state)
        if eval_fn is not None and (step_i + 1) % tcfg.ckpt_every == 0:
            eval_fn(state, step_i)
    return state, metrics


def find_best_checkpoint(ckpt_dir: str, template: TrainState, eval_fn):
    """Sweep saved checkpoints by an eval score (test_net.py:357-381).
    eval_fn(state) -> float score (higher better). Returns (path, score)."""
    import glob as _glob
    import os as _os
    best = (None, -float("inf"))
    for path in sorted(_glob.glob(_os.path.join(ckpt_dir, "ckpt_*"))):
        state = restore_checkpoint(path, template)
        score = float(eval_fn(state))
        if score > best[1]:
            best = (path, score)
    return best


# ----------------------------------------------------------------- checkpoint

def save_checkpoint(path: str, state: TrainState):
    """Orbax checkpoint (the Estimator ckpt equivalent, utils.py:563-566).
    Orbax rejects relative paths; absolutize so fit()'s periodic saves
    work with a relative ckpt_dir."""
    import os as _os

    import orbax.checkpoint as ocp
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(_os.path.abspath(path), state)
    ckptr.wait_until_finished()


def restore_checkpoint(path: str, template: TrainState) -> TrainState:
    import os as _os

    import orbax.checkpoint as ocp
    ckptr = ocp.StandardCheckpointer()
    return ckptr.restore(_os.path.abspath(path), template)
