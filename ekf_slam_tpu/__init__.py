"""ekf_slam_tpu — a batched, accelerator-resident EKF-SLAM engine.

A from-scratch JAX/XLA re-design of the capabilities of the reference
MonoSLAM (matlab_code/) + CALC2.0 (CALC 2.0/) codebase:

* 6-DoF monocular EKF-SLAM with inverse-depth landmarks, analytic Jacobians,
  1-point RANSAC robust data association and two-phase (low/high innovation)
  updates — re-designed as a padded fixed-capacity, masked, branchless,
  jit-compiled step that vmaps over thousands of filter instances per
  device.
* A variational convolutional autoencoder ("CALC2"-class) for visual loop
  closure, in Flax, with data-parallel training over a jax.sharding.Mesh.

Nothing in this package is a translation of the reference code; the reference
defines *behavior* (equations, thresholds, pipeline order), cited per-module
as matlab_code/<file>.m:<line> or "CALC 2.0/<file>.py:<line>".
"""

__version__ = "0.1.0"

from ekf_slam_tpu import config  # noqa: F401
