"""Differentiable homography augmentation ("CALC 2.0"/layers.py).

* `estimate_hom` (layers.py:141-156): the reference builds the 4-point DLT
  system and takes the null vector via a batched SVD of the 8x9 matrix. A
  4-point homography is EXACT, so the same H (up to scale) comes from fixing
  h33 = 1 and solving the square 8x8 system — one batched LU solve instead
  of an SVD, far cheaper on an accelerator. (SVD would only differ for
  >4 points.)
* `hom_warp` (layers.py:28-139): bilinear resampling of the warped [-1,1]
  grid — here a vectorized gather instead of the reference's flattened
  index arithmetic.
* `rand_warp` (layers.py:4-26): random corner perturbation with
  max_warp = 0.5, corners drawn in [-1, -1+mw] / [1-mw, 1].
* brightness jitter + conditional clamp (calc2.py:266-269).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def estimate_hom(src: jnp.ndarray, dst: jnp.ndarray) -> jnp.ndarray:
    """Batched 4-point DLT. src, dst: (B, 4, 2). Returns (B, 3, 3) with
    H @ [src; 1] ∝ [dst; 1] (same convention as layers.py:141-156)."""
    rx, ry = src[..., 0:1], src[..., 1:2]
    x, y = dst[..., 0:1], dst[..., 1:2]
    z = jnp.zeros_like(rx)
    o = jnp.ones_like(rx)
    # Rows in (h11..h32) unknowns with h33 = 1 moved to the RHS.
    rows_x = jnp.concatenate(
        [-rx, -ry, -o, z, z, z, rx * x, ry * x], axis=-1)
    rows_y = jnp.concatenate(
        [z, z, z, -rx, -ry, -o, rx * y, ry * y], axis=-1)
    A = jnp.concatenate([rows_x, rows_y], axis=-2)       # (B, 8, 8)
    b = jnp.concatenate([-x, -y], axis=-2)               # (B, 8, 1)
    h = jnp.linalg.solve(A, b)[..., 0]                   # (B, 8)
    H = jnp.concatenate([h, jnp.ones(h.shape[:-1] + (1,), h.dtype)], -1)
    return H.reshape(h.shape[:-1] + (3, 3))


def hom_warp(images: jnp.ndarray, out_hw, H: jnp.ndarray) -> jnp.ndarray:
    """Warp NHWC images by per-image homographies over a [-1,1]² grid with
    bilinear sampling and edge clamping (layers.py:28-139 semantics)."""
    B, h_in, w_in, C = images.shape
    out_h, out_w = out_hw
    xs = jnp.linspace(-1.0, 1.0, out_w, dtype=images.dtype)
    ys = jnp.linspace(-1.0, 1.0, out_h, dtype=images.dtype)
    gx, gy = jnp.meshgrid(xs, ys)                         # (out_h, out_w)
    grid = jnp.stack([gx.ravel(), gy.ravel(),
                      jnp.ones(out_h * out_w, images.dtype)])  # (3, N)
    warped = H @ grid                                     # (B, 3, N)
    wx = warped[:, 0, :] / warped[:, 2, :]
    wy = warped[:, 1, :] / warped[:, 2, :]
    # [-1,1] -> pixel coords (the reference scales by size, layers.py:56-57)
    fx = (wx + 1.0) * w_in / 2.0
    fy = (wy + 1.0) * h_in / 2.0

    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = fx - x0
    ty = fy - y0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, w_in - 1)
    x1i = jnp.clip(x0i + 1, 0, w_in - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h_in - 1)
    y1i = jnp.clip(y0i + 1, 0, h_in - 1)

    def gather(yi, xi):
        # (B, N, C) gather per image
        return jax.vmap(lambda im, yy, xx: im[yy, xx])(images, yi, xi)

    Ia = gather(y0i, x0i)
    Ib = gather(y1i, x0i)
    Ic = gather(y0i, x1i)
    Id = gather(y1i, x1i)
    wa = ((1 - tx) * (1 - ty))[..., None]
    wb = ((1 - tx) * ty)[..., None]
    wc = (tx * (1 - ty))[..., None]
    wd = (tx * ty)[..., None]
    out = wa * Ia + wb * Ib + wc * Ic + wd * Id
    return out.reshape(B, out_h, out_w, C)


def rand_warp(key: jax.Array, images: jnp.ndarray, out_hw,
              max_warp: float = 0.5) -> jnp.ndarray:
    """Random 4-corner homography warp (layers.py:4-26, max_warp 0.5)."""
    B = images.shape[0]
    kx1, kx2, ky1, ky2 = jax.random.split(key, 4)
    dt = images.dtype
    corners = jnp.array([[-1.0, -1.0], [-1.0, 1.0], [1.0, -1.0], [1.0, 1.0]],
                        dt)
    src = jnp.broadcast_to(corners, (B, 4, 2))
    rx1 = jax.random.uniform(kx1, (B, 2, 1), dt, -1.0, -1.0 + max_warp)
    rx2 = jax.random.uniform(kx2, (B, 2, 1), dt, 1.0 - max_warp, 1.0)
    rx = jnp.concatenate([rx1, rx2], axis=1)              # (B, 4, 1)
    ry1 = jax.random.uniform(ky1, (B, 2, 1), dt, -1.0, -1.0 + max_warp)
    ry2 = jax.random.uniform(ky2, (B, 2, 1), dt, 1.0 - max_warp, 1.0)
    ry = jnp.concatenate([ry1, ry2], axis=2).reshape(B, 4, 1)
    dst = jnp.concatenate([rx, ry], axis=2)
    H = estimate_hom(src, dst)
    return hom_warp(images, out_hw, H)


def random_crop(key: jax.Array, images: jnp.ndarray,
                labels_onehot: jnp.ndarray, out_hw,
                per_image: bool = True):
    """Random joint image+label crop to `out_hw` — the reference crops
    the channel-concatenated (img, label) tensor to [vh, vw] inside
    model_fn (calc2.py:254-258), training the 192x256 network on crops
    of the 320x320 shard images (gen_tfrecords.py writes 320x320).

    DOCUMENTED GENERALIZATION: the reference's tf.image.random_crop
    with a [B, vh, vw, C] size draws ONE offset shared by the whole
    batch; per_image=True (default) draws per-image offsets — same
    marginal distribution per image, strictly more diverse batches, at
    the cost of a vmapped dynamic_slice instead of one slice.
    per_image=False reproduces the reference's shared-offset behavior.
    """
    B, H, W, _ = images.shape
    vh, vw = out_hw
    joint = jnp.concatenate(
        [images, labels_onehot.astype(images.dtype)], axis=-1)
    C = joint.shape[-1]
    if per_image:
        ky, kx = jax.random.split(key)
        oy = jax.random.randint(ky, (B,), 0, H - vh + 1)
        ox = jax.random.randint(kx, (B,), 0, W - vw + 1)
        cut = jax.vmap(lambda im, y, x: jax.lax.dynamic_slice(
            im, (y, x, 0), (vh, vw, C)))
        joint = cut(joint, oy, ox)
    else:
        ky, kx = jax.random.split(key)
        oy = jax.random.randint(ky, (), 0, H - vh + 1)
        ox = jax.random.randint(kx, (), 0, W - vw + 1)
        joint = jax.lax.dynamic_slice(joint, (0, oy, ox, 0), (B, vh, vw, C))
    n_img = images.shape[-1]
    return joint[..., :n_img], joint[..., n_img:].astype(labels_onehot.dtype)


def positive_view(key: jax.Array, images: jnp.ndarray,
                  max_warp: float = 0.5) -> jnp.ndarray:
    """The training 'positive' augmentation (calc2.py:264-269): random
    left-right flip + rand_warp + random brightness shift in [-0.8, 0],
    keeping the shift only when the warped image is bright enough."""
    kf, kw, kb = jax.random.split(key, 3)
    B, H, W, C = images.shape
    flip = jax.random.bernoulli(kf, 0.5, (B,))
    images = jnp.where(flip[:, None, None, None], images[:, :, ::-1, :],
                       images)
    warped = rand_warp(kw, images, (H, W), max_warp)
    shift = jax.random.uniform(kb, (B, 1, 1, 1), images.dtype, -0.8, 0.0)
    adjusted = jnp.clip(warped + shift, 0.0, 1.0)
    mean = jnp.mean(warped, axis=(1, 2, 3), keepdims=True)
    return jnp.where(mean < 0.2, warped, adjusted)


def eval_view(key: jax.Array, images: jnp.ndarray,
              max_warp: float = 0.3, severity: float = 0.0) -> jnp.ndarray:
    """A held-out 'revisit' view for EVALUATION pairs: moderate
    viewpoint homography + illumination shift, NO mirror flip; severity
    > 0 adds the `seasonal_change` appearance model on top.

    The reference evaluates on real revisit pairs (CampusLoopDataset,
    test_net.py:44-99) — viewpoint and lighting change, never mirrored.
    The random flip in positive_view is a TRAINING trick (calc2.py:264);
    evaluating against flipped views makes the local-keypoint geometric
    verification unsolvable by construction (activation-difference
    descriptors are not mirror-invariant, and neither are FREAK/BRIEF)."""
    kw, kb, ks = jax.random.split(key, 3)
    B, H, W, C = images.shape
    warped = rand_warp(kw, images, (H, W), max_warp)
    shift = jax.random.uniform(kb, (B, 1, 1, 1), images.dtype, -0.5, 0.0)
    adjusted = jnp.clip(warped + shift, 0.0, 1.0)
    mean = jnp.mean(warped, axis=(1, 2, 3), keepdims=True)
    out = jnp.where(mean < 0.2, warped, adjusted)
    if severity > 0.0:
        out = seasonal_change(ks, out, severity)
    return out


def seasonal_change(key: jax.Array, images: jnp.ndarray,
                    severity: float = 1.0,
                    n_occluders: int = 3) -> jnp.ndarray:
    """Appearance change of a REAL revisit (the CampusLoopDataset pairs the
    reference evaluates on are cross-season: snow, foliage, lighting,
    transient objects — test_net.py:44-99). The plain global brightness
    shift of `eval_view` is normalized away by any L2-normalized
    descriptor; this models the parts that are not:

    * a low-frequency multiplicative illumination field (sun angle /
      shadows): coarse 4x5 gain grid in [1−0.6s, 1+0.6s], bilinearly
      upsampled;
    * additive sensor noise, sigma = 0.08·s;
    * `n_occluders` random gray rectangles (~1/5 of each side) per image
      (parked cars, pedestrians, seasonal vegetation).

    severity s = 0 is the identity; s = 1 drops untrained-descriptor
    retrieval to roughly chance-plus on the bundled scenes, restoring the
    headroom that makes the trained-vs-untrained PR-AUC lift meaningful.
    """
    kg, kn, kb, kv, kf = jax.random.split(key, 5)
    B, H, W, C = images.shape
    dt = images.dtype
    gain = jax.random.uniform(kg, (B, 4, 5, 1), dt,
                              1.0 - 0.6 * severity, 1.0 + 0.6 * severity)
    gain = jax.image.resize(gain, (B, H, W, 1), "bilinear")
    out = images * gain
    out = out + jax.random.normal(kn, out.shape, dt) * (0.08 * severity)
    # Occluder rectangles: branchless masks from per-image box params.
    yy = jnp.arange(H, dtype=dt)[None, None, :, None, None]  # (1,1,H,1,1)
    xx = jnp.arange(W, dtype=dt)[None, None, None, :, None]  # (1,1,1,W,1)
    cy = jax.random.uniform(kb, (B, n_occluders, 1, 1, 1), dt, 0.0, H)
    cx = jax.random.uniform(kv, (B, n_occluders, 1, 1, 1), dt, 0.0, W)
    hh = 0.1 * severity * H
    ww = 0.1 * severity * W
    inside = ((jnp.abs(yy - cy) < hh) & (jnp.abs(xx - cx) < ww))
    occluded = jnp.any(inside, axis=1)                       # (B, H, W, 1)
    fill = jax.random.uniform(kf, (B, 1, 1, C), dt, 0.3, 0.7)
    out = jnp.where(occluded, fill, out)
    return jnp.clip(out, 0.0, 1.0)
