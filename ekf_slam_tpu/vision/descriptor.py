"""Binary intensity-comparison descriptor (FREAK-class).

The reference extracts FREAK descriptors around FAST corners and matches
with a Hamming matcher (matching.m:45-47, initialize_a_feature.m:51-54).
FREAK's retina sampling is an OpenCV-compiled pattern; bit-for-bit parity is
out of scope (SURVEY.md §7 "Hard parts"). This is the same *family*: a
fixed pseudo-random pair-comparison pattern over a smoothed patch — a
BRIEF/FREAK-style binary descriptor, expressed as ±1 floats so matching is
ONE matmul (Hamming distance ≡ (N − dot)/2 for ±1 vectors).
"""

from __future__ import annotations

import os as _os

import jax
import jax.numpy as jnp

N_BITS = 256
PATCH = 15          # descriptor support (odd)

# Candidate-describe lowering form (EKF_DESCRIBE): "onehot" = per-slot
# region cut + exact one-hot matmul extraction (describe_windows, no
# per-candidate gather; the default) — 25k random reads (slice) or
# flat-index gathers ("flat") replaced by S dense region cuts + matmul
# selection, the same gather→matmul conversion as the patch warp. Which
# form is fastest on the GPU is not measured yet. All forms
# bit-equivalent (pinned in tests/test_vision.py).
_MANY_FORM = _os.environ.get("EKF_DESCRIBE", "onehot")

# Patch-from-region extraction form inside describe_regions
# (EKF_REGEXTRACT): "onehot" = two exact one-hot matmul contractions
# (default); "flat" = one single-axis take_along_axis from the compact
# (S, RG²) region stack — unlike the full-image flat gather, the
# operand here is ~600 KB, not the whole frame. Both
# bit-identical (same pinned tests cover describe_windows).
_REG_FORM = _os.environ.get("EKF_REGEXTRACT", "onehot")


def _pattern(key=None):
    """Fixed comparison pattern: N_BITS pairs of offsets in the patch,
    Gaussian-concentrated like BRIEF. Computed in NumPy (a seeded host-side
    constant): importing this module must NOT trigger device work (an
    import-time jax.random call would initialize the backend and compile)."""
    import numpy as np
    rng = np.random.default_rng(1234)
    r = PATCH // 2
    a = np.clip(np.round(rng.standard_normal((N_BITS, 2)) * r / 2.5),
                -r, r).astype(np.int32)
    b = np.clip(np.round(rng.standard_normal((N_BITS, 2)) * r / 2.5),
                -r, r).astype(np.int32)
    return a, b


_PAT_A, _PAT_B = _pattern()


def _smooth3(img: jnp.ndarray) -> jnp.ndarray:
    """3x3 box smoothing (BRIEF requires pre-smoothing)."""
    out = jnp.zeros_like(img)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out = out + jnp.roll(img, (dy, dx), axis=(-2, -1))
    return out / 9.0


def describe(img: jnp.ndarray, yx: jnp.ndarray) -> jnp.ndarray:
    """Descriptors at K keypoints. img: (H, W); yx: (K, 2) int32.
    Returns (K, N_BITS) ±1 floats."""
    return describe_presmoothed(_smooth3(img), yx)


def describe_presmoothed(sm: jnp.ndarray, yx: jnp.ndarray) -> jnp.ndarray:
    """describe() given an already-smoothed image — callers describing many
    keypoint batches per frame (the per-slot matcher) smooth once."""
    H, W = sm.shape
    r = PATCH // 2
    y = jnp.clip(yx[:, 0], r, H - 1 - r)
    x = jnp.clip(yx[:, 1], r, W - 1 - r)
    ya = y[:, None] + _PAT_A[None, :, 0]
    xa = x[:, None] + _PAT_A[None, :, 1]
    yb = y[:, None] + _PAT_B[None, :, 0]
    xb = x[:, None] + _PAT_B[None, :, 1]
    bits = sm[ya, xa] > sm[yb, xb]
    return jnp.where(bits, 1.0, -1.0).astype(sm.dtype)


def _sel_diff():
    """(PATCH², N_BITS) constant: column `bit` has +1 at pattern point A's
    flat patch index and -1 at B's (0 where they coincide), so
    patch_flat @ _SEL_DIFF reproduces sm[a] − sm[b] for every bit at
    once. Host-side NumPy constant (no import-time device work)."""
    import numpy as np
    r = PATCH // 2
    sel = np.zeros((PATCH * PATCH, N_BITS), np.float32)
    pa = (_PAT_A[:, 0] + r) * PATCH + (_PAT_A[:, 1] + r)
    pb = (_PAT_B[:, 0] + r) * PATCH + (_PAT_B[:, 1] + r)
    sel[pa, np.arange(N_BITS)] += 1.0
    sel[pb, np.arange(N_BITS)] -= 1.0
    return sel


_SEL_DIFF = _sel_diff()


def _describe_many_flat(sm: jnp.ndarray, yx: jnp.ndarray) -> jnp.ndarray:
    """describe_many via ONE flat-index gather with minor dim 225.

    The slice form's vmapped dynamic_slice materializes (K, 15, 15)
    patches with two small minor dims (a poor layout on tiled memory),
    plus a relayout on the reshape to (K, 225). Here the patch grid
    becomes 225 STATIC flat offsets into sm.reshape(-1), so the gather
    lands as (K, 225) directly and feeds the selector matmul with no
    intermediate. Same clipping, bit-identical (pinned)."""
    H, W = sm.shape
    r = PATCH // 2
    y0 = jnp.clip(yx[:, 0], r, H - 1 - r) - r
    x0 = jnp.clip(yx[:, 1], r, W - 1 - r) - r
    import numpy as np
    offs = (np.arange(PATCH)[:, None] * W + np.arange(PATCH)[None, :])
    idx = (y0 * W + x0)[:, None] + jnp.asarray(offs.reshape(-1), y0.dtype)
    patches = sm.reshape(-1)[idx]                       # (K, 225)
    diff = jnp.dot(patches, jnp.asarray(_SEL_DIFF, sm.dtype),
                   precision=jax.lax.Precision.HIGHEST)
    return jnp.where(diff > 0, 1.0, -1.0).astype(sm.dtype)


def describe_windows(sm: jnp.ndarray, h_pred: jnp.ndarray,
                     wy: jnp.ndarray, wx: jnp.ndarray,
                     search_radius: int) -> jnp.ndarray:
    """Describe all S×C window candidates with NO per-candidate gather.

    The slice form's 25k vmapped (15,15) dynamic_slices are latency-bound
    random reads (the flat-gather form measured even slower — the cost is
    access count, not padded bytes). Candidates are grouped: all C of a
    slot lie in its (2R+1)² search window, so cut ONE
    (2R+15)² region per SLOT (S dense slices instead of S·C·15 strided
    row reads) and extract each (15,15) patch from its region with two
    EXACT one-hot matmul contractions — the same gather→matmul
    conversion as the patch warp. One-hot
    rows select exactly one region value per output (all other products
    are 0·x), so the result is bit-identical to describe_presmoothed
    (pinned in tests/test_vision.py).

    Args: h_pred (S, 2) predicted (u, v) window centers — the SAME values
    the candidate search anchored on; wy/wx (S, C) candidate offsets
    inside the (2R+1)² window. Returns (S, C, N_BITS) ±1.
    """
    from ekf_slam_tpu.vision import ncc
    H, W = sm.shape
    r = PATCH // 2
    R = search_radius

    def cut(h):
        return ncc.extract_patch_anchored(sm, h, R + r)
    regions, ru0, rv0 = jax.vmap(cut)(h_pred)            # (S, RG, RG)

    # Window anchor (same clipped round as the candidate search used).
    u0 = jnp.clip(jnp.round(h_pred[:, 0]).astype(jnp.int32) - R, 0,
                  W - (2 * R + 1))
    v0 = jnp.clip(jnp.round(h_pred[:, 1]).astype(jnp.int32) - R, 0,
                  H - (2 * R + 1))
    return describe_regions(regions, ru0, rv0, u0, v0, wy, wx, H, W)


def describe_regions(regions: jnp.ndarray, ru0: jnp.ndarray,
                     rv0: jnp.ndarray, u0: jnp.ndarray, v0: jnp.ndarray,
                     wy: jnp.ndarray, wx: jnp.ndarray,
                     H: int, W: int) -> jnp.ndarray:
    """One-hot matmul patch extraction given pre-cut per-slot regions.

    regions (S, RG, RG) anchored at (ru0, rv0) in image coordinates —
    anchors may be NEGATIVE when the region came from a zero-padded
    shared plane (frontend EKF_MATCHWIN=shared): candidate patch centers
    are clipped inside the true image below, so padding values are never
    selected and the result stays bit-identical to describe_presmoothed.
    (u0, v0) (S,) are the search-window anchors the candidate offsets
    wy/wx (S, C) are relative to. Returns (S, C, N_BITS) ±1."""
    r = PATCH // 2
    RG = regions.shape[-1]
    S_, C_ = wy.shape
    # Patch starts, global (describe_presmoothed's center clip), then
    # relative to the region anchor — always within [0, RG-PATCH].
    cy = jnp.clip(v0[:, None] + wy, r, H - 1 - r) - r
    cx = jnp.clip(u0[:, None] + wx, r, W - 1 - r) - r
    oy = cy - rv0[:, None]                               # (S, C)
    ox = cx - ru0[:, None]
    hi = jax.lax.Precision.HIGHEST

    if _REG_FORM == "flat":
        # Flat single-axis gather from the per-slot region — the operand
        # is the compact (S, RG²) region stack, NOT the full image (the
        # full-image flat gather lost at 606.1: 25k scattered HBM rows).
        # 225 static offsets from each candidate's flat start.
        import numpy as np
        offs = (np.arange(PATCH)[:, None] * RG
                + np.arange(PATCH)[None, :]).reshape(-1)
        idx = (oy * RG + ox)[..., None] + jnp.asarray(offs, oy.dtype)
        patch = jnp.take_along_axis(
            regions.reshape(S_, RG * RG),
            idx.reshape(S_, C_ * PATCH * PATCH), axis=1)
    else:
        grid = jnp.arange(RG)
        prange = jnp.arange(PATCH)
        # (S, C, PATCH, RG) one-hots: row p of candidate (s,c) selects
        # region row oy+p (resp. column ox+q). f32 0/1 entries keep the
        # dots exact.
        OY = (oy[..., None, None] + prange[None, None, :, None]
              == grid).astype(regions.dtype)
        OX = (ox[..., None, None] + prange[None, None, :, None]
              == grid).astype(regions.dtype)
        rows = jnp.einsum("scpY,sYX->scpX", OY, regions, precision=hi)
        patch = jnp.einsum("scpX,scqX->scpq", rows, OX, precision=hi)
    diff = jnp.dot(patch.reshape(S_ * C_, PATCH * PATCH),
                   jnp.asarray(_SEL_DIFF, regions.dtype), precision=hi)
    return jnp.where(diff > 0, 1.0, -1.0).astype(regions.dtype) \
        .reshape(S_, C_, N_BITS)


def describe_many(sm: jnp.ndarray, yx: jnp.ndarray) -> jnp.ndarray:
    """describe_presmoothed, restructured for LARGE keypoint batches (the
    per-slot-per-candidate matcher: CAP × corners_per_window points).

    The direct form's sm[ya, xa] is a 2-D-index gather of K·2·N_BITS
    scalars — under the B × CAP × candidates vmap it lowers to monster
    index plumbing (the same batched-operand-gather problem the patch
    warp had). Here each keypoint cuts ONE (15, 15)
    patch (contiguous dynamic_slice) and all 256 comparisons become a
    single constant-selector matmul: bits = patch @ (1ₐ − 1ᵦ) > 0,
    algebraically identical (sm[a] > sm[b] ⇔ sm[a] − sm[b] > 0);
    HIGHEST precision keeps the difference f32-exact (no TF32). Pinned
    bit-identical to describe_presmoothed in tests/test_vision.py."""
    if _MANY_FORM == "flat":
        return _describe_many_flat(sm, yx)
    H, W = sm.shape
    r = PATCH // 2
    y0 = jnp.clip(yx[:, 0], r, H - 1 - r) - r
    x0 = jnp.clip(yx[:, 1], r, W - 1 - r) - r

    def cut(yy, xx):
        return jax.lax.dynamic_slice(sm, (yy, xx), (PATCH, PATCH))

    patches = jax.vmap(cut)(y0, x0).reshape(yx.shape[0], -1)
    diff = jnp.dot(patches, jnp.asarray(_SEL_DIFF, sm.dtype),
                   precision=jax.lax.Precision.HIGHEST)
    return jnp.where(diff > 0, 1.0, -1.0).astype(sm.dtype)


def hamming_distance(d1: jnp.ndarray, d2: jnp.ndarray) -> jnp.ndarray:
    """(K1, N)±1 x (K2, N)±1 -> (K1, K2) Hamming distances via one matmul."""
    return 0.5 * (d1.shape[-1] - d1 @ d2.T)


def match(d1: jnp.ndarray, d2: jnp.ndarray, max_distance: float):
    """Nearest-neighbor Hamming matching with a distance gate — the
    matchFeatures equivalent (matching.m:45-47 uses MaxRatio 1, Unique,
    MatchThreshold; uniqueness here = forward NN only).
    Returns (idx2 (K1,), valid (K1,))."""
    dist = hamming_distance(d1, d2)
    idx = jnp.argmin(dist, axis=-1)
    best = jnp.min(dist, axis=-1)
    return idx, best <= max_distance
