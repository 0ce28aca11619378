"""Activation keypoints + local descriptors ("CALC 2.0"/utils.py:88-174).

The reference extracts, per 4x4 grid cell of the conv5 activation map and
per channel, the argmax location as a keypoint; its orientation is the
arctan of the activation gradient; the local descriptor is the 8-neighbor
activation-difference stack. That implementation is a host-side NumPy loop
with dynamic dedup (np.unique) and cv2.KeyPoint construction.

Redesign — fixed shapes, no host loops:
* `kp_descriptor(c5)` is fully batched: (B, H, W, C) -> exactly
  B x (GRID² x C) keypoints with (y, x), response, orientation and the
  8C-dim neighbor-difference descriptor, computed with vectorized gathers.
* The reference's dedup (keep max-response among coincident keypoints,
  utils.py:119-138) is a dynamic-shape op; retrieval quality only needs the
  ratio test over descriptors, so duplicates are kept (they match
  themselves consistently). Deviation documented here.
* The reference has an off-by-cell bug (`ky_*(i+1)` instead of
  `ky_ + i*cell_h`, utils.py:104-105) that scrambles keypoint positions for
  cells beyond the first row/col; this implements the evident intent
  (cell-local argmax offset by the cell origin).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

GRID = 4  # utils.py:96 (n = 4)


class Keypoints(NamedTuple):
    yx: jnp.ndarray          # (B, K, 2) float — keypoint positions
    response: jnp.ndarray    # (B, K) activation at the keypoint
    orientation: jnp.ndarray  # (B, K) gradient angle
    descr: jnp.ndarray       # (B, K, 8*C) neighbor-difference descriptor


def kp_descriptor(c5: jnp.ndarray) -> Keypoints:
    """c5: (B, H, W, C) conv activations. K = GRID*GRID*C keypoints."""
    B, H, W, C = c5.shape
    ch, cw = H // GRID, W // GRID
    # (B, GRID, ch, GRID, cw, C) -> cells (B, GRID*GRID, ch*cw, C)
    cells = c5.reshape(B, GRID, ch, GRID, cw, C)
    cells = cells.transpose(0, 1, 3, 2, 4, 5).reshape(
        B, GRID * GRID, ch * cw, C)
    flat_idx = jnp.argmax(cells, axis=2)                    # (B, G², C)
    ky_local = flat_idx // cw
    kx_local = flat_idx % cw
    cell_ids = jnp.arange(GRID * GRID)
    cell_y0 = (cell_ids // GRID) * ch
    cell_x0 = (cell_ids % GRID) * cw
    ky = ky_local + cell_y0[None, :, None]                  # (B, G², C)
    kx = kx_local + cell_x0[None, :, None]

    # Keep keypoints 1 px off the border so the 8-neighborhood is in-bounds
    # (the reference pads with zeros; clamping is equivalent up to border
    # responses, utils.py:141-142 clamps the same way).
    ky = jnp.clip(ky, 1, H - 2).reshape(B, -1)              # (B, K)
    kx = jnp.clip(kx, 1, W - 2).reshape(B, -1)
    K = ky.shape[1]
    chan = jnp.broadcast_to(jnp.arange(C)[None, None, :],
                            (B, GRID * GRID, C)).reshape(B, -1)

    def per_image(img, yy, xx, cc):
        # response / orientation from the keypoint's own channel
        resp = img[yy, xx, cc]
        gy = img[jnp.clip(yy + 1, 0, H - 1), xx, cc] - \
            img[jnp.clip(yy - 1, 0, H - 1), xx, cc]
        gx = img[yy, jnp.clip(xx + 1, 0, W - 1), cc] - \
            img[yy, jnp.clip(xx - 1, 0, W - 1), cc]
        theta = jnp.arctan2(gy, gx)
        # 8-neighbor differences over ALL channels (utils.py:155-170)
        offs = jnp.array([[-1, -1], [-1, 0], [-1, 1], [0, -1],
                          [0, 1], [1, -1], [1, 0], [1, 1]])
        nb = img[yy[:, None] + offs[None, :, 0],
                 xx[:, None] + offs[None, :, 1]]            # (K, 8, C)
        d = nb - img[yy, xx][:, None, :]                    # center diff
        return resp, theta, d.reshape(K, 8 * C)

    resp, theta, descr = jax.vmap(per_image)(c5, ky, kx, chan)
    yx = jnp.stack([ky, kx], axis=-1).astype(c5.dtype)
    return Keypoints(yx=yx, response=resp, orientation=theta, descr=descr)


def ratio_test_matches(d1: jnp.ndarray, d2: jnp.ndarray,
                       ratio: float = 0.7):
    """Mutual-best keypoint matching with Lowe ratio test — the BFMatcher
    knnMatch(k=2) + ratio step of close_kitti_loops.py:30-38, batched.

    d1: (K1, D), d2: (K2, D). Returns (idx2 (K1,), valid (K1,)).
    """
    # Squared L2 distances via the matmul identity.
    n1 = jnp.sum(d1 * d1, axis=-1, keepdims=True)
    n2 = jnp.sum(d2 * d2, axis=-1)
    dist = n1 + n2[None, :] - 2.0 * (d1 @ d2.T)             # (K1, K2)
    idx = jnp.argmin(dist, axis=-1)
    best = jnp.min(dist, axis=-1)
    # second-best: mask the best out
    is_best = jax.nn.one_hot(idx, dist.shape[1], dtype=jnp.float32) > 0
    masked = jnp.where(is_best, jnp.inf, dist)
    second = jnp.min(masked, axis=-1)
    valid = best < (ratio * ratio) * second                  # squared ratio
    return idx, valid
