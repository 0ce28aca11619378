"""Typed configuration tree.

The reference scatters constants across use sites; this module collects all of
them into frozen (hashable → jit-static) dataclasses. Sources:

* camera calibration    — matlab_code/initialize_cam.m:3-11
* filter noise / motion — matlab_code/mono_slam.m:29-32, initialize_x_and_p.m:4-24,
                          predict_state_and_covariance.m:5 (delta_t = 1)
* feature init          — matlab_code/initialize_a_feature.m:4-11,
                          initialize_features.m:5 (max_attempts = 50)
* matching              — matlab_code/matching.m:2,16,21-27 (chi2 gate 5.9915,
                          eig(S) < 100 gate, ±2σ search window)
* 1-point RANSAC        — matlab_code/ransac_hypotheses.m:3-9 (p = 0.99,
                          threshold = std_z, 1000 initial hypotheses)
* map management        — matlab_code/mono_slam.m:39 (min 25 features),
                          inversedepth_2_cartesian.m:3 (linearity thr 0.1);
                          the delete rule implements the policy the missing
                          matlab_code/delete_features.m was meant to apply
                          (SURVEY.md §2.9): drop a feature once
                          times_measured < 0.5 * times_predicted after >= 5
                          predictions.
* CALC2 hyperparameters — "CALC 2.0"/calc2.py:27-49, utils.py:502-507.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp

# Motion model identifiers (matlab_code/fv.m:8-47). Static ints so the jitted
# step can specialize without string comparisons.
CONSTANT_VELOCITY = 0
CONSTANT_ORIENTATION = 1
CONSTANT_POSITION = 2
CONSTANT_POSITION_AND_ORIENTATION = 3

# State-vector layout: camera block [r(3) q(4) v(3) w(3)] then CAP 6-wide
# landmark slots (inverse-depth: [x y z theta phi rho]; cartesian: [x y z 0 0 0]).
CAM_DIM = 13


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole + 2-parameter radial distortion (initialize_cam.m:3-11)."""

    n_rows: int = 240
    n_cols: int = 320
    d: float = 0.0112           # mm / pixel (dx == dy in the reference)
    cx: float = 1.7945 / 0.0112
    cy: float = 1.4433 / 0.0112
    k1: float = 6.333e-2
    k2: float = 1.390e-2
    f: float = 2.1735
    distort_newton_iters: int = 10  # distort_fm.m:28-32

    @property
    def fku(self) -> float:
        return self.f / self.d

    @property
    def fkv(self) -> float:
        return self.f / self.d


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """EKF noise / motion-model settings (mono_slam.m:29-32)."""

    sigma_a: float = 0.007      # linear acceleration noise std
    sigma_alpha: float = 0.007  # angular acceleration noise std
    sigma_z: float = 1.0        # image measurement noise std (pixels)
    motion_model: int = CONSTANT_VELOCITY
    delta_t: float = 1.0        # predict_state_and_covariance.m:5
    # initialize_x_and_p.m:4-10
    v_0: float = 0.0
    std_v_0: float = 0.025
    w_0: float = 1e-15
    std_w_0: float = 0.025
    eps_pose: float = 2.220446049250313e-16  # MATLAB eps on pose diagonal
    # Iterated (Gauss-Newton) low-innovation update — the reference's
    # intended-but-missing IEKF path (ekf_update_iterated.m, SURVEY.md §2.9)
    use_iterated_update: bool = False
    iekf_iterations: int = 3
    # Gain solver for S⁻¹: "cholesky" (exact; sequential triangular work) or
    # "newton" (Newton-Schulz, pure matmuls; ~1e-6 relative accuracy at f32 —
    # see ekf._spd_inverse_newton)
    gain_solver: str = "cholesky"
    # Share RANSAC's per-slot P Hᵀ columns ((D, CAP, 2), one P-read einsum)
    # with both EKF updates instead of each update re-computing a dense
    # P @ Hᵀ (engine.step_core). Bit-identical math; a throughput knob,
    # off by default (not measured on the GPU yet).
    share_pht: bool = False
    # Covariance storage dtype: "f32" (default; required by the golden
    # 1e-6-equivalence guarantee) or "bf16" — P carried and materialized in
    # bfloat16 with ALL algebra still f32 (upcast fused into reads,
    # downcast into writes: ekf.p_compute/p_store). Halves the HBM traffic
    # of every full-P pass at ~0.4% per-write rounding; a consistency-
    # analyzed fast mode (tests/test_bf16_storage.py), not a parity mode.
    p_storage: str = "f32"


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Fixed-capacity map + management policy."""

    capacity: int = 100                       # landmark slots (BASELINE.json)
    min_features_in_image: int = 25           # mono_slam.m:39
    initial_rho: float = 1.0                  # initialize_a_feature.m:10
    std_rho: float = 1.0                      # initialize_a_feature.m:11
    linearity_threshold: float = 0.1          # inversedepth_2_cartesian.m:3
    max_init_attempts: int = 50               # initialize_features.m:5
    max_new_per_step: int = 25                # candidate batch per init pass
    #   (initialize_features.m adds up to the deficit; we cap the per-step
    #   candidate scatter at this static count to stay fixed-shape)
    # Compact updates: gather at most this many measurement slots into the
    # EKF update (2*max_update_obs rows instead of 2*capacity). Identical
    # result whenever <= max_update_obs slots pass the inlier masks; excess
    # inliers are dropped (lowest slot indices win). 0 = full-width updates.
    max_update_obs: int = 64
    # delete policy (replaces the missing delete_features.m, SURVEY.md §2.9)
    delete_min_predictions: int = 5
    delete_measured_ratio: float = 0.5
    # feature-initialization exclusion geometry (initialize_a_feature.m:4-9)
    half_patch_init: int = 20
    half_patch_match: int = 6
    init_box_w: int = 60
    init_box_h: int = 40

    @property
    def state_dim(self) -> int:
        return CAM_DIM + 6 * self.capacity


@dataclasses.dataclass(frozen=True)
class MatchingConfig:
    """Individual-compatibility gating (matching.m)."""

    chi2_inv_2_95: float = 5.9915   # matching.m:2
    max_innovation_eig: float = 100.0  # matching.m:16
    sigma_search: float = 2.0       # matching.m:21-27 (±2σ window)
    fov_limit_deg: float = 60.0     # hi_inverse_depth.m:37-43


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """1-point RANSAC (ransac_hypotheses.m).

    The reference runs an adaptive sequential loop starting at 1000
    hypotheses and shrinking via n = log(1-p)/log(1-eps_inlier). Here we
    run a fixed batch of `num_hypotheses` in parallel and take the argmax of
    support — statistically at least as strong as the adaptive loop whenever
    num_hypotheses >= the adaptive count, which holds for the operating
    regime here: with the reference's own termination formula, inlier ratios
    >= 7% already terminate the loop within 64 iterations
    (log(0.01)/log(1-0.07) ≈ 63.6) and SLAM association typically runs far
    above that ratio. See tests/test_ransac.py for the equivalence test.

    Do NOT shrink the budget to a shorter run's measured minimum: a fixed
    count must cover the WORST frame of the longest intended sequence.
    Measured on the bench workload (the NHYP horizon study):
    32 hypotheses track 16-frame sequences but go non-finite at 24 frames,
    while 64 stay clean — one bad association compounds over the
    map-building horizon.
    """

    p_at_least_one_spurious_free: float = 0.99  # ransac_hypotheses.m:3
    num_hypotheses: int = 64


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """Image front-end (vision/): FAST + NCC matching parameters.

    The search window is static (matching.m derives a dynamic ±2σ box,
    matching.m:21-27 — here positions beyond the χ² ellipse are masked
    inside the fixed window instead)."""

    search_radius: int = 12        # static search half-size (px)
    min_ncc: float = 0.5           # NCC acceptance (crosscorr path)
    fast_threshold: float = 0.08   # contrast threshold on [0,1] images
    fast_arc: int = 9              # FAST-9 contiguous arc
    exclusion_radius: float = 10.0  # min distance to tracked features (px)
    # Runtime matcher: "descriptor" = FAST corners in the gated window +
    # binary-descriptor Hamming match against the init descriptor — the
    # reference's PRIMARY path (matching.m:29-47, FAST+FREAK) and the
    # default here to match it (also the more accurate mode: tracking
    # err 0.0639 vs 0.092 on the bench workload);
    # "ncc" = warped-template NCC scan (the crosscorr.m legacy path,
    # BASELINE.json configs[3]) — the pixels bench keeps BENCH_MATCHER=ncc
    # as its explicit default for cross-round continuity.
    matcher: str = "descriptor"
    corners_per_window: int = 8    # FAST candidates kept per search window
    max_hamming: float = 64.0      # descriptor acceptance (of N_BITS=256)
    # Template-warp distortion handling (rotate_with_dist_fc_c1c2.m:12-17):
    # "exact" per-pixel round trip, "affine" anchor-exact first-order
    # correction (<0.1 px residual, measured in tests/test_vision.py),
    # "none" raw pixels (up to ~16 px template shift at frame corners —
    # the round-1 behavior, kept for A/B only).
    warp_distortion: str = "affine"


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Synthetic scene generator (replaces the absent image sequence,
    mono_slam.m:21 / SURVEY.md §2.9)."""

    num_landmarks: int = 72
    world_radius: float = 4.0
    depth_min: float = 0.8
    depth_max: float = 6.0
    pixel_noise_std: float = 1.0
    outlier_fraction: float = 0.05
    outlier_shift_px: float = 30.0
    # ground-truth initial linear/angular velocity of the camera
    v_init: Tuple[float, float, float] = (0.02, 0.0, 0.005)
    w_init: Tuple[float, float, float] = (0.0, 0.004, 0.0)
    # white-acceleration excitation of the TRUE trajectory; None = use the
    # filter's sigma_a/sigma_alpha (matched generative model)
    traj_accel_std: float | None = None
    traj_alpha_std: float | None = None


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Top-level config tree."""

    camera: CameraConfig = CameraConfig()
    filter: FilterConfig = FilterConfig()
    map: MapConfig = MapConfig()
    matching: MatchingConfig = MatchingConfig()
    ransac: RansacConfig = RansacConfig()
    vision: VisionConfig = VisionConfig()
    sim: SimConfig = SimConfig()
    dtype: str = "float32"   # compute dtype; "float64" for the oracle path
    # NaN/Inf guard on the post-update state each frame — the
    # tf.check_numerics parity (calc2.py:311-313); aborts under jit via
    # jax.debug.check when tripped.
    debug_nan_checks: bool = False

    @property
    def jnp_dtype(self):
        return jnp.dtype(self.dtype)

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


DEFAULT = EngineConfig()
