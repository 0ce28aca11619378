"""Multi-chip scaling utilities (SURVEY.md §2.8).

The reference's only parallelism is single-host data parallelism
(MirroredStrategy, "CALC 2.0"/utils.py:558-559). The scaling model
here:

* **data axis** — filter instances (Monte-Carlo ensembles) and CALC2
  training batches shard over a 1-D `Mesh(("data",))`; gradients and
  ensemble statistics all-reduce over the interconnect (XLA-inserted
  psum).
* **model axis** — reserved in `make_mesh(model=k)` for sharding CALC2
  conv channels if ever needed; the reference has nothing equivalent
  (no TP/PP/SP/EP anywhere — SURVEY.md §2.8), so parity needs only DP.

`run_ensemble` is the multi-chip Monte-Carlo evaluator: B filter instances
sharded over chips, each scanning the same observation sequence with its
own RNG stream, returning per-instance trajectories plus cross-ensemble
mean/covariance (one psum over the interconnect).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices=None) -> Mesh:
    """1-D ('data',) mesh by default; 2-D ('data', 'model') when model > 1."""
    devices = jax.devices() if devices is None else devices
    n = len(devices) if data is None else data * model
    devs = np.asarray(devices[:n])
    if model == 1:
        return Mesh(devs, ("data",))
    return Mesh(devs.reshape(-1, model), ("data", "model"))


def shard_batch(tree, mesh: Mesh, axis: str = "data"):
    """Place a batched pytree with the leading axis sharded over `axis`."""
    def shard_leaf(a):
        spec = P(axis, *([None] * (a.ndim - 1)))
        return jax.device_put(a, NamedSharding(mesh, spec))
    return jax.tree.map(shard_leaf, tree)


def replicate(tree, mesh: Mesh):
    return jax.tree.map(
        lambda a: jax.device_put(a, NamedSharding(mesh, P())), tree)


def run_ensemble(state_batch, obs_seq, keys, cfg, mesh: Mesh):
    """Sharded Monte-Carlo ensemble of full SLAM runs.

    state_batch: FilterState with leading batch axis (sharded over 'data');
    obs_seq: FrameObs with leading time axis (replicated); keys: (B,) RNG.
    Returns (final states, trajectories (B,T,13), ensemble mean trajectory
    (T,13), ensemble position covariance (T,3,3)).
    """
    from ekf_slam_tpu.filter import engine

    state_batch = shard_batch(state_batch, mesh)
    keys = shard_batch(keys, mesh)
    obs_seq = replicate(obs_seq, mesh)

    @jax.jit
    def run(states, obs, ks):
        final, traj, infos = jax.vmap(
            lambda s, k: engine.run_sequence(s, obs, k, cfg))(states, ks)
        mean = jnp.mean(traj, axis=0)              # psum over the mesh
        dev = traj[..., 0:3] - mean[None, ..., 0:3]
        cov = jnp.einsum("bti,btj->tij", dev, dev) / traj.shape[0]
        return final, traj, mean, cov

    return run(state_batch, obs_seq, keys)
