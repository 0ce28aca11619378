"""Patch appearance prediction via plane-induced homography.

Behavior source: matlab_code/predict_features_appearance.m:1-27 +
pred_patch_fc.m:1-55 (+ the rotate_with_dist_fc_c1c2/c2c1 point-transfer
helpers): when a feature is about to be matched, its stored 41x41
initialization patch is warped into the current view by the homography a
fronto-parallel plane at the feature induces between the init camera and the
current camera, then cropped to the 13x13 matching patch.

Fixed-shape redesign: the reference warps through per-pixel
undistort/rotate/distort round trips (rotate_with_dist_fc_c1c2.m:12-17) with
interp2. Here the plane homography H = K (R − t nᵀ / d) K⁻¹ is composed once
per feature in UNDISTORTED pixel space, then (default) corrected for lens
distortion by folding anchor-exact first-order distortion maps into the 3x3
(distortion_corrected_homography) so the warp stays ONE batched bilinear
gather. The reference-faithful per-pixel round trip is kept as
warp_patch_distorted / predict_appearance(distortion="exact");
tests/test_vision.py measures the affine default against it (<0.1 px
residual across the frame, vs up-to-16-px template shift at corners if
distortion is ignored — the round-1 "none" mode).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from ekf_slam_tpu.config import CameraConfig
from ekf_slam_tpu.ops import quaternion as quat

# 3x3 inverse form (A/B knob): "closed" = adjugate/determinant closed
# form — pure fused elementwise arithmetic; "linalg" = jnp.linalg.inv /
# solve, which lower to batched LU custom paths. The warp runs under a
# CAP-and-instance double vmap, so each feature pays the 3x3 chain;
# the closed form keeps it in one fusion.
_INV3 = os.environ.get("EKF_WARP_INV", "closed")

# Bilinear sampling form (A/B knob): "gather" = four per-corner gathers
# from the vmapped patch store (batched-operand gathers relayout);
# "dot" = one-hot interpolation-weight matrices contracted as matmuls —
# out[k] = Wy[k,:] @ patch @ Wx[k,:]ᵀ with Wy/Wx built by iota-compare
# (2 nonzeros per row), no gather at all. Same 4-term bilinear algebra.
# DEFAULT "dot" (the batched-operand gathers were the warp's real cost
# where it was chosen; not re-measured on the GPU), with the same
# tracking error as "gather" (0.0922 vs 0.0934) — reduced-precision
# default matmul passes do not degrade matching.
_SAMPLE = os.environ.get("EKF_WARP_SAMPLE", "dot")


def inv3(M: jnp.ndarray) -> jnp.ndarray:
    """Closed-form 3x3 inverse (adjugate / determinant), batched over
    leading axes. Exact-math equivalent of jnp.linalg.inv for 3x3;
    homographies here are well-conditioned (dets ~ 1)."""
    if _INV3 == "linalg":
        return jnp.linalg.inv(M)
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    adj = jnp.stack([jnp.stack([A, B, C], -1),
                     jnp.stack([D, E, F], -1),
                     jnp.stack([G, H, I], -1)], -2)
    return adj / det[..., None, None]


def camera_matrix(cam: CameraConfig, dtype=jnp.float32) -> jnp.ndarray:
    fku = cam.f / cam.d
    return jnp.array([[fku, 0.0, cam.cx],
                      [0.0, fku, cam.cy],
                      [0.0, 0.0, 1.0]], dtype)


def camera_matrix_inv(cam: CameraConfig, dtype=jnp.float32) -> jnp.ndarray:
    fku = cam.f / cam.d
    return jnp.array([[1.0 / fku, 0.0, -cam.cx / fku],
                      [0.0, 1.0 / fku, -cam.cy / fku],
                      [0.0, 0.0, 1.0]], dtype)


def plane_homography(r1, q1, r2, q2, p_w, cam: CameraConfig) -> jnp.ndarray:
    """Homography mapping pixels of camera 1 (init pose) to camera 2
    (current pose) for a plane through world point p_w whose normal is the
    init viewing ray (fronto-parallel assumption of pred_patch_fc.m:20-38).

    All inputs trailing-batch; returns (..., 3, 3).
    """
    K = camera_matrix(cam, p_w.dtype)
    R1 = quat.q2r(q1)                       # world <- cam1
    R2 = quat.q2r(q2)
    # cam2 <- cam1 relative transform
    R = jnp.swapaxes(R2, -1, -2) @ R1
    t = jnp.einsum("...ij,...j->...i", jnp.swapaxes(R2, -1, -2), r1 - r2)
    # plane in cam1 coordinates: normal n1 (unit ray to p), depth d1
    p1 = jnp.einsum("...ij,...j->...i", jnp.swapaxes(R1, -1, -2), p_w - r1)
    d1 = jnp.linalg.norm(p1, axis=-1, keepdims=True)
    d_safe = jnp.where(d1 == 0, jnp.ones_like(d1), d1)
    n1 = p1 / d_safe
    H_metric = R + t[..., :, None] * n1[..., None, :] / d_safe[..., None]
    return K @ H_metric @ camera_matrix_inv(cam, p_w.dtype)


def warp_patch(patch: jnp.ndarray, H: jnp.ndarray, center_src,
               center_dst, out_size: int) -> jnp.ndarray:
    """Warp a square patch through H. patch: (P, P) centered at pixel
    `center_src` (2,) = (u, v) in the source image; output (out, out)
    centered at `center_dst` in the destination image, sampled by the
    INVERSE map dst->src (pred_patch_fc.m builds the same meshgrid+interp2).
    """
    return warp_patch_inv(patch, inv3(H), center_src, center_dst, out_size)


def warp_patch_inv(patch: jnp.ndarray, Hinv: jnp.ndarray, center_src,
                   center_dst, out_size: int) -> jnp.ndarray:
    """warp_patch given the PRE-INVERTED dst->src homography — the affine
    distortion path composes this inverse in closed form, so the forward
    H never needs to be built and re-inverted."""
    P = patch.shape[-1]
    o = out_size // 2
    d = jnp.arange(-o, o + 1, dtype=patch.dtype)
    gy, gx = jnp.meshgrid(d, d, indexing="ij")
    du = gx + center_dst[0]
    dv = gy + center_dst[1]
    ones = jnp.ones_like(du)
    pts = jnp.stack([du, dv, ones], axis=0).reshape(3, -1)
    src = Hinv @ pts
    su = src[0] / src[2] - center_src[0] + (P // 2)
    sv = src[1] / src[2] - center_src[1] + (P // 2)
    return _bilinear(patch, su, sv, out_size)


def _bilinear(patch: jnp.ndarray, su: jnp.ndarray, sv: jnp.ndarray,
              out_size: int) -> jnp.ndarray:
    P = patch.shape[-1]
    x0 = jnp.clip(jnp.floor(su).astype(jnp.int32), 0, P - 2)
    y0 = jnp.clip(jnp.floor(sv).astype(jnp.int32), 0, P - 2)
    tx = jnp.clip(su - x0, 0.0, 1.0)
    ty = jnp.clip(sv - y0, 0.0, 1.0)
    if _SAMPLE == "dot":
        # Gather-free: two-nonzero one-hot weight rows contracted against
        # the patch. Under the CAP x instance vmap the gathers below
        # index a batched operand (a whole-store relayout copy + padded
        # index plumbing); this form is two clean batched contractions.
        dt = patch.dtype
        xi = jnp.arange(P, dtype=jnp.int32)
        Wx = ((xi[None, :] == x0[:, None]).astype(dt) * (1 - tx)[:, None]
              + (xi[None, :] == x0[:, None] + 1).astype(dt)
              * tx[:, None])                                 # (K, P)
        Wy = ((xi[None, :] == y0[:, None]).astype(dt) * (1 - ty)[:, None]
              + (xi[None, :] == y0[:, None] + 1).astype(dt)
              * ty[:, None])                                 # (K, P)
        out = jnp.einsum("kp,kp->k", Wy @ patch, Wx)
        return out.reshape(out_size, out_size)
    out = (patch[y0, x0] * (1 - tx) * (1 - ty)
           + patch[y0 + 1, x0] * (1 - tx) * ty
           + patch[y0, x0 + 1] * tx * (1 - ty)
           + patch[y0 + 1, x0 + 1] * tx * ty)
    return out.reshape(out_size, out_size)


def distortion_corrected_homography(H: jnp.ndarray, center_src,
                                    center_dst,
                                    cam: CameraConfig) -> jnp.ndarray:
    """Compose the undistorted-space homography H with first-order
    distortion corrections so it can be applied DIRECTLY to distorted
    pixel coordinates: map = A_src⁻¹ ∘ H ∘ A_dst... more precisely the
    returned 3x3 M satisfies, to first order around the patch centers,

        distort(H_u · undistort(p_dst)) ≈ M · p_dst

    with EXACT equality at center_dst (the anchor is mapped through the
    true undistort→H→distort round trip — removing the up-to-16-px
    systematic template shift the raw-pixel application of H has at frame
    corners with the reference calibration; tests/test_vision.py measures
    the residual at <0.1 px over a 13-px patch). One extra Newton distort
    + two 2x2 Jacobians per feature — no per-pixel round trip."""
    A_dst, A_src, Hinv = _distortion_affine_anchors(H, center_dst, cam)
    del center_src  # anchoring uses the true H⁻¹ image of the dst center
    return _inv_affine(A_dst) @ H @ _inv_affine(A_src)


def distortion_corrected_hinv(H: jnp.ndarray, center_dst,
                              cam: CameraConfig) -> jnp.ndarray:
    """The INVERSE distortion-corrected map A_src ∘ H⁻¹ ∘ A_dst — what
    warp_patch_inv actually samples through — composed directly in closed
    form (one adjugate 3x3 inverse + two affine products), instead of
    building the forward map and LU-inverting it per feature."""
    A_dst, A_src, Hinv = _distortion_affine_anchors(H, center_dst, cam)
    return A_src @ Hinv @ A_dst


def _distortion_affine_anchors(H: jnp.ndarray, center_dst,
                               cam: CameraConfig):
    """Shared anchor math: (A_dst, A_src, H⁻¹) with
    A_dst: distorted dst -> undistorted dst, anchored (exactly) at
    center_dst; A_src: undistorted src -> distorted src, anchored at
    H⁻¹(center_dst)."""
    from ekf_slam_tpu.ops import camera as cam_ops
    dt = H.dtype
    c_dst = jnp.asarray(center_dst, dt)
    u_dst = cam_ops.undistort(c_dst, cam)                  # anchor, exact
    Ju = cam_ops.jacob_undistort(c_dst, cam)               # d undist / d dist
    A_dst = jnp.eye(3, dtype=dt)
    A_dst = A_dst.at[:2, :2].set(Ju).at[:2, 2].set(u_dst - Ju @ c_dst)
    # Anchor through H⁻¹ (projective) -> undistorted src point.
    Hinv = inv3(H)
    s = Hinv @ jnp.concatenate([u_dst, jnp.ones((1,), dt)])
    s_u = s[:2] / s[2]
    s_d = cam_ops.distort(s_u, cam)                        # exact anchor
    Jd = cam_ops.jacob_distort(s_d, cam)   # d dist / d undist, AT s_d
    A_src = jnp.eye(3, dtype=dt)
    A_src = A_src.at[:2, :2].set(Jd).at[:2, 2].set(s_d - Jd @ s_u)
    return A_dst, A_src, Hinv


def _inv_affine(A: jnp.ndarray) -> jnp.ndarray:
    """Closed-form inverse of an affine 3x3 (last row 0 0 1)."""
    a, b = A[..., 0, 0], A[..., 0, 1]
    c, d = A[..., 1, 0], A[..., 1, 1]
    det = a * d - b * c
    inv2 = jnp.stack([jnp.stack([d, -b], -1),
                      jnp.stack([-c, a], -1)], -2) / det[..., None, None]
    t = -jnp.einsum("...ij,...j->...i", inv2, A[..., :2, 2])
    out = jnp.zeros_like(A).at[..., 2, 2].set(1.0)
    return out.at[..., :2, :2].set(inv2).at[..., :2, 2].set(t)


def warp_patch_distorted(patch: jnp.ndarray, H: jnp.ndarray, center_src,
                         center_dst, out_size: int,
                         cam: CameraConfig) -> jnp.ndarray:
    """warp_patch with the reference's per-pixel distortion round trip
    (rotate_with_dist_fc_c1c2.m:12-17): each destination pixel (distorted
    image coordinates) is undistorted, mapped through the inverse
    undistorted-space homography, then re-distorted (Newton) into source
    image coordinates before the bilinear gather. ~3x the arithmetic of
    warp_patch for a 13x13 patch; tests/test_vision.py measures the
    deviation of the fast path against this one."""
    from ekf_slam_tpu.ops import camera as cam_ops
    P = patch.shape[-1]
    o = out_size // 2
    d = jnp.arange(-o, o + 1, dtype=patch.dtype)
    gy, gx = jnp.meshgrid(d, d, indexing="ij")
    dst = jnp.stack([gx + center_dst[0], gy + center_dst[1]], axis=-1)
    dst_u = cam_ops.undistort(dst, cam)                    # (o, o, 2)
    ones = jnp.ones(dst_u.shape[:-1] + (1,), patch.dtype)
    pts = jnp.concatenate([dst_u, ones], axis=-1).reshape(-1, 3)
    src_u = pts @ inv3(H).T
    src_u = src_u[:, :2] / src_u[:, 2:3]
    src_d = cam_ops.distort(src_u, cam)
    su = src_d[:, 0] - center_src[0] + (P // 2)
    sv = src_d[:, 1] - center_src[1] + (P // 2)
    return _bilinear(patch, su, sv, out_size)


def predict_appearance(patches: jnp.ndarray, init_pose: jnp.ndarray,
                       x_cam: jnp.ndarray, p_w: jnp.ndarray,
                       h_init: jnp.ndarray, h_now: jnp.ndarray,
                       cam: CameraConfig, out_size: int = 13,
                       distortion: str = "affine") -> jnp.ndarray:
    """Batch over features (predict_features_appearance.m loop, vmapped).

    patches: (CAP, P, P) stored init patches; init_pose: (CAP, 7) [r q] at
    initialization (add_feature_to_info_vector.m r_wc/R_wc fields);
    x_cam: (13,) current camera state; p_w: (CAP, 3) current landmark
    estimates; h_init/h_now: (CAP, 2) pixel locations at init/predicted now.
    Returns (CAP, out, out) predicted matching patches.

    `distortion`: how rotate_with_dist_fc_c1c2.m's per-pixel round trip is
    treated — "exact" (per-pixel, reference-faithful), "affine" (default:
    anchor-exact first-order correction folded into the homography,
    <0.1 px residual at 1/3 the cost), "none" (raw pixels, up to ~16 px
    template shift at frame corners with the reference calibration).
    """
    r2 = x_cam[0:3]
    q2 = x_cam[3:7]

    def one(patch, pose1, p, hi, hn):
        H = plane_homography(pose1[0:3], pose1[3:7], r2, q2, p, cam)
        if distortion == "exact":
            return warp_patch_distorted(patch, H, hi, hn, out_size, cam)
        if distortion == "affine":
            # Compose the dst->src sampling map directly (closed form) —
            # no forward corrected H is ever built or re-inverted.
            return warp_patch_inv(patch, distortion_corrected_hinv(
                H, hn, cam), hi, hn, out_size)
        return warp_patch(patch, H, hi, hn, out_size)

    return jax.vmap(one)(patches, init_pose, p_w, h_init, h_now)
