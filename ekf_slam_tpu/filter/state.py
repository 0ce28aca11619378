"""Padded fixed-capacity filter state.

The reference grows/shrinks the state vector and covariance dynamically per
feature add/delete (add_features_inverse_depth.m:20-21, delete_a_feature.m:21-25)
— under jit that is a recompile per shape. Here the state is allocated once at
capacity:

* ``x``: (13 + 6*CAP,) — camera block [r(3) q(4) v(3) w(3)] followed by CAP
  6-wide landmark slots. Inverse-depth slot: [x y z theta phi rho]
  (hinv.m:26). Cartesian slot: [x y z 0 0 0] — conversion zero-masks the
  angular/rho dims instead of physically shrinking the vector
  (inversedepth_2_cartesian.m:37-45 row surgery becomes an in-place reparam).
* ``P``: full joint covariance at capacity. Dead slots carry zero rows/cols,
  which is algebraically identical to the reference's physical removal: the
  Kalman gain rows and all cross terms for a zero row/col stay exactly zero
  through predict (F only touches the 13-dim camera block,
  predict_state_and_covariance.m:26-27) and update (K = P Hᵀ S⁻¹).
* per-slot masks/counters replacing the features_info bookkeeping fields
  (add_feature_to_info_vector.m:7-32): ``active``, ``cartesian``,
  ``times_predicted``, ``times_measured``, and ``landmark_id`` (ground-truth
  association handle for the synthetic-scene path; -1 when unused).

The struct is a pytree (utils/pytree.py), so it vmaps/shards/checkpoints as
data.
"""

from __future__ import annotations

import jax.numpy as jnp

from ekf_slam_tpu.config import CAM_DIM, EngineConfig
from ekf_slam_tpu.utils import pytree


@pytree.dataclass
class FilterState:
    x: jnp.ndarray                # (D,)
    P: jnp.ndarray                # (D, D)
    active: jnp.ndarray           # (CAP,) bool
    cartesian: jnp.ndarray        # (CAP,) bool
    times_predicted: jnp.ndarray  # (CAP,) int32
    times_measured: jnp.ndarray   # (CAP,) int32
    landmark_id: jnp.ndarray      # (CAP,) int32

    @property
    def capacity(self) -> int:
        return self.active.shape[-1]

    @property
    def cam(self) -> jnp.ndarray:
        """Camera block [r q v w] of the state vector."""
        return self.x[..., :CAM_DIM]

    def slot_values(self) -> jnp.ndarray:
        """Landmark slots as (CAP, 6)."""
        cap = self.capacity
        return self.x[..., CAM_DIM:].reshape(*self.x.shape[:-1], cap, 6)


def init_state(cfg: EngineConfig) -> FilterState:
    """Initial state (initialize_x_and_p.m:1-24): identity pose at the
    origin, v0 = 0, w0 = 1e-15, P diag = [eps(7), std_v², std_w²]."""
    f = cfg.filter
    cap = cfg.map.capacity
    dt = cfg.jnp_dtype
    d = cfg.map.state_dim
    x = jnp.zeros(d, dt)
    x = x.at[3].set(1.0)
    x = x.at[7:10].set(f.v_0)
    x = x.at[10:13].set(f.w_0)
    diag = jnp.zeros(d, dt)
    diag = diag.at[0:7].set(f.eps_pose)
    diag = diag.at[7:10].set(f.std_v_0**2)
    diag = diag.at[10:13].set(f.std_w_0**2)
    P = jnp.diag(diag)
    if f.p_storage == "bf16" and dt == jnp.float32:
        P = P.astype(jnp.bfloat16)
    return FilterState(
        x=x,
        P=P,
        active=jnp.zeros(cap, bool),
        cartesian=jnp.zeros(cap, bool),
        times_predicted=jnp.zeros(cap, jnp.int32),
        times_measured=jnp.zeros(cap, jnp.int32),
        landmark_id=jnp.full(cap, -1, jnp.int32),
    )
