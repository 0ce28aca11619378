"""Synthetic scene / sequence generator (self-contained evaluation data).

The reference consumes a monocular image sequence that is absent from the
repo (`matlab_code/mono_slam.m:21` points at ../sequences/ic/rawoutput, not
bundled — SURVEY.md §2.9). To make the engine testable and benchmarkable
end-to-end without external data, this module generates:

* a random landmark field in front of the camera start pose,
* a ground-truth camera trajectory propagated by the same constant-velocity
  motion model the filter assumes (`matlab_code/fv.m:42-47`) plus white
  acceleration excitation — i.e. the exact generative model the EKF's
  process noise describes,
* per-frame pixel observations through the full camera model (projection +
  2-parameter radial distortion, `matlab_code/hu.m`, `distort_fm.m`) with
  Gaussian pixel noise and a configurable fraction of gross outliers, which
  exercise the 1-point RANSAC path (`matlab_code/ransac_hypotheses.m`).

Everything is fixed-shape: observations come as a dense (L, 2) pixel array +
(L,) visibility mask per frame, so the whole sequence jits and vmaps over
Monte-Carlo instances.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ekf_slam_tpu.config import CAM_DIM, EngineConfig
from ekf_slam_tpu.filter import motion
from ekf_slam_tpu.ops import camera as cam_ops
from ekf_slam_tpu.ops import quaternion as quat
from ekf_slam_tpu.utils import pytree


@pytree.dataclass
class Scene:
    """Static world: ground-truth landmark positions (L, 3)."""
    landmarks: jnp.ndarray


@pytree.dataclass
class FrameObs:
    """One frame of observations, dense over all world landmarks.

    pixels:  (L, 2) distorted pixel measurement per landmark (garbage where
             not visible — gated by `visible`).
    visible: (L,) bool — landmark projects inside the image with z > 0.
    """
    pixels: jnp.ndarray
    visible: jnp.ndarray


def make_scene(key: jax.Array, cfg: EngineConfig) -> Scene:
    """Sample a landmark field inside the camera's initial viewing frustum.

    Landmarks are drawn by back-projecting random in-image pixels to random
    depths in [depth_min, depth_max] — guarantees initial visibility.
    """
    s = cfg.sim
    cam = cfg.camera
    k1, k2 = jax.random.split(key)
    # Keep a margin off the image border so small motions keep them in view.
    uv = jax.random.uniform(
        k1, (s.num_landmarks, 2),
        minval=jnp.array([0.15 * cam.n_cols, 0.15 * cam.n_rows]),
        maxval=jnp.array([0.85 * cam.n_cols, 0.85 * cam.n_rows]))
    depth = jax.random.uniform(k2, (s.num_landmarks,),
                               minval=s.depth_min, maxval=s.depth_max)
    uvu = cam_ops.undistort(uv, cam)
    fku = cam.f / cam.d
    rays = jnp.stack([(uvu[:, 0] - cam.cx) / fku,
                      (uvu[:, 1] - cam.cy) / fku,
                      jnp.ones(s.num_landmarks)], axis=-1)
    return Scene(landmarks=(rays * depth[:, None]).astype(cfg.jnp_dtype))


def simulate_trajectory(key: jax.Array, cfg: EngineConfig, num_steps: int):
    """Ground-truth 13-dim camera states (T, 13) under constant velocity +
    white acceleration — the generative model of func_Q.m."""
    f = cfg.filter
    x0 = jnp.zeros(CAM_DIM)
    x0 = x0.at[3].set(1.0)
    x0 = x0.at[7:10].set(jnp.asarray(cfg.sim.v_init))
    x0 = x0.at[10:13].set(jnp.asarray(cfg.sim.w_init))

    sa = cfg.sim.traj_accel_std if cfg.sim.traj_accel_std is not None else f.sigma_a
    sw = (cfg.sim.traj_alpha_std if cfg.sim.traj_alpha_std is not None
          else f.sigma_alpha)

    def body(x, k):
        ka, kw = jax.random.split(k)
        x = motion.fv(x, f)
        x = x.at[7:10].add(sa * f.delta_t * jax.random.normal(ka, (3,)))
        x = x.at[10:13].add(sw * f.delta_t * jax.random.normal(kw, (3,)))
        x = x.at[3:7].set(x[3:7] / jnp.linalg.norm(x[3:7]))
        return x, x

    _, xs = jax.lax.scan(body, x0, jax.random.split(key, num_steps))
    return jnp.concatenate([x0[None], xs[:-1]], axis=0).astype(cfg.jnp_dtype)


def observe(key: jax.Array, scene: Scene, x_cam: jnp.ndarray,
            cfg: EngineConfig) -> FrameObs:
    """Project all landmarks through the true pose; add noise + outliers.

    Mirrors the geometry of hi_cartesian.m (h_C = R_cw (y − t)) followed by
    project + distort, with the same in-image/positive-depth gates the
    matcher would impose.
    """
    s = cfg.sim
    cam = cfg.camera
    kn, ko, kd = jax.random.split(key, 3)
    t_wc, q_wc = x_cam[0:3], x_cam[3:7]
    R_wc = quat.q2r(q_wc)
    hc = (scene.landmarks - t_wc) @ R_wc          # R_cwᵀ rows → camera frame
    z_ok = hc[:, 2] > 1e-3
    hc_safe = jnp.where(z_ok[:, None], hc, jnp.array([0.0, 0.0, 1.0]))
    px = cam_ops.distort(cam_ops.project(hc_safe, cam), cam)
    px = px + s.pixel_noise_std * jax.random.normal(kn, px.shape)
    # Gross outliers: shift by outlier_shift_px in a random direction.
    is_out = jax.random.uniform(ko, (px.shape[0],)) < s.outlier_fraction
    ang = jax.random.uniform(kd, (px.shape[0],), maxval=2 * jnp.pi)
    shift = s.outlier_shift_px * jnp.stack([jnp.cos(ang), jnp.sin(ang)], -1)
    px = jnp.where(is_out[:, None], px + shift, px)
    vis = (z_ok & (px[:, 0] > 0) & (px[:, 0] < cam.n_cols)
           & (px[:, 1] > 0) & (px[:, 1] < cam.n_rows))
    return FrameObs(pixels=px.astype(cfg.jnp_dtype), visible=vis)


def simulate(key: jax.Array, cfg: EngineConfig, num_steps: int):
    """Full dataset: (scene, true states (T,13), FrameObs batched over T)."""
    ks, kt, ko = jax.random.split(key, 3)
    scene = make_scene(ks, cfg)
    xs = simulate_trajectory(kt, cfg, num_steps)
    obs = jax.vmap(lambda k, x: observe(k, scene, x, cfg))(
        jax.random.split(ko, num_steps), xs)
    return scene, xs, obs
