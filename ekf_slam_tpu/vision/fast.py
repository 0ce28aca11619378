"""FAST-16 corner detection as dense vectorized ops.

Replaces the reference's detectFASTFeatures calls (matching.m:29,
initialize_a_feature.m:29-31, MinContrast 0.40). The classic FAST test: a
pixel is a corner when >= `arc` CONTIGUOUS pixels on its 16-pixel Bresenham
circle are all brighter than center + t or all darker than center − t.

Fixed-shape design: the 16 circle taps are 16 static rolls of the image (pure
shifts — fused by XLA into one stencil), the contiguous-arc test is a
log-step run-length computation on the doubled mask, and non-max
suppression is a 3x3 max-pool comparison. Everything is (H, W) dense and
batches over leading axes.
"""

from __future__ import annotations

import os as _os

import jax
import jax.numpy as jnp
import numpy as np

# Arc-test lowering form (EKF_FASTARC): "runlen" = int32 log-doubling run
# length over the doubled 32-row sequence (the original form, current
# default); "and" = AND-doubling over the boolean (16, H, W) taps
# (strictly fewer/narrower passes; the default flips only after the
# bench decides). Bit-equivalent; pinned in
# tests/test_vision.py.
_ARC_FORM = _os.environ.get("EKF_FASTARC", "runlen")
# Tap-extraction form, same bench-first policy (see _taps).
_TAPS_FORM = _os.environ.get("EKF_FASTTAPS", "roll")

# 16-point Bresenham circle of radius 3, clockwise (standard FAST layout).
# NumPy, not jnp: a module-level device array would initialize the JAX
# backend at import time.
CIRCLE = np.array([
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1)])


def _taps(img: jnp.ndarray) -> jnp.ndarray:
    """(16, …, H, W) circle intensities.

    Form knob (EKF_FASTTAPS): "roll" = 16 wrapped rolls (2 concats per
    axis each); "pad" = one zero-pad then 16 STATIC slices (no wraparound
    concats — the 3-px border is zeroed by fast_score either way, so the
    forms agree on the interior and the score maps are identical; pinned
    in tests/test_vision.py)."""
    if _TAPS_FORM == "pad":
        H, W = img.shape[-2:]
        pad = [(0, 0)] * (img.ndim - 2) + [(3, 3), (3, 3)]
        ip = jnp.pad(img, pad)
        return jnp.stack(
            [jax.lax.slice_in_dim(
                jax.lax.slice_in_dim(ip, 3 + int(dy), 3 + int(dy) + H, axis=-2),
                3 + int(dx), 3 + int(dx) + W, axis=-1)
             for dy, dx in CIRCLE.tolist()], axis=0)
    return jnp.stack(
        [jnp.roll(img, (-int(dy), -int(dx)), axis=(-2, -1))
         for dy, dx in CIRCLE.tolist()], axis=0)


def _max_contiguous_run(mask: jnp.ndarray) -> jnp.ndarray:
    """Maximum circular run of True along axis 0 of a (16, ...) mask, via
    log-doubling on the doubled sequence (run length capped at 16)."""
    m = jnp.concatenate([mask, mask], axis=0).astype(jnp.int32)  # (32, ...)
    # run[i] = run length starting at i, exact once below the cap 2^k:
    # extend only SATURATED runs (run == 2^k) by the run at i + 2^k.
    run = m
    for k in range(5):
        s = 1 << k
        shifted = jnp.concatenate(
            [run[s:], jnp.zeros_like(run[:s])], axis=0)
        run = jnp.where(run == s, s + shifted, run)
    return jnp.minimum(jnp.max(run[:16], axis=0), 16)


def _has_circular_run(mask: jnp.ndarray, arc: int) -> jnp.ndarray:
    """(16, ...) bool -> (...) bool: does any CIRCULAR contiguous run of
    True along axis 0 reach `arc`?

    AND-doubling form: p_L[i] = AND of mask[i..i+L-1] (circular) built for
    power-of-two L, then composed per the binary decomposition of `arc`
    (r_{A+L}[i] = r_A[i] & p_L[(i+A) mod 16]). Boolean rolls of the (16,…)
    axis only — no doubled 32-row int32 sequence, no integer compares —
    exactly equivalent to thresholding _max_contiguous_run at `arc` (pinned
    in tests/test_vision.py)."""
    arc = min(int(arc), 16)
    powers = {1: mask}
    L = 1
    while L * 2 <= arc:
        powers[L * 2] = powers[L] & jnp.roll(powers[L], -L, axis=0)
        L *= 2
    r = None
    acc = 0
    for bit in sorted(powers, reverse=True):
        if acc + bit <= arc:
            p = powers[bit]
            r = p if r is None else r & jnp.roll(p, -acc, axis=0)
            acc += bit
    return jnp.any(r, axis=0)


def fast_score(img: jnp.ndarray, threshold: float = 0.08,
               arc: int = 9) -> jnp.ndarray:
    """Corner response map (…, H, W) -> (…, H, W) float score.

    Score = contrast margin when the contiguous-arc test passes, else 0.
    `threshold` plays the role of MinContrast (initialize_a_feature.m:30)
    on [0, 1] images.
    """
    taps = _taps(img)
    diff = taps - img[None]
    bright = diff > threshold
    dark = diff < -threshold
    if _ARC_FORM == "runlen":
        is_corner = (_max_contiguous_run(bright) >= arc) | \
                    (_max_contiguous_run(dark) >= arc)
    else:
        is_corner = _has_circular_run(bright, arc) | \
                    _has_circular_run(dark, arc)
    # Response: mean absolute contrast of the qualifying taps (a smooth
    # stand-in for the OpenCV score; ordering is what matters downstream).
    margin = jnp.mean(
        jnp.where(bright | dark, jnp.abs(diff) - threshold, 0.0), axis=0)
    score = jnp.where(is_corner, margin, 0.0)
    # Zero the 3-px border the rolls wrapped around.
    H, W = img.shape[-2:]
    yy = jnp.arange(H)[:, None]
    xx = jnp.arange(W)[None, :]
    interior = (yy >= 3) & (yy < H - 3) & (xx >= 3) & (xx < W - 3)
    return score * interior


def non_max_suppress(score: jnp.ndarray, radius: int = 1) -> jnp.ndarray:
    """Keep only local maxima within a (2r+1)² window."""
    H, W = score.shape[-2:]
    neigh = score
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy == 0 and dx == 0:
                continue
            neigh = jnp.maximum(
                neigh, jnp.roll(score, (dy, dx), axis=(-2, -1)))
    return jnp.where(score >= neigh, score, 0.0)


def top_corners(score: jnp.ndarray, k: int):
    """Top-k corners of a suppressed score map. Returns (yx (k, 2) int32,
    scores (k,)); zero-score entries mean 'no corner'."""
    import jax
    H, W = score.shape[-2:]
    flat = score.reshape(score.shape[:-2] + (H * W,))
    vals, idx = jax.lax.top_k(flat, k)
    yx = jnp.stack([idx // W, idx % W], axis=-1).astype(jnp.int32)
    return yx, vals
