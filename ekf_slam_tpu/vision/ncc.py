"""Normalized cross-correlation patch matching over a gated search window.

Behavior sources:
* crosscorr.m:1-27 — zero-mean NCC of equal-size patches (the legacy
  matching path the reference kept; BASELINE.json configs[3] names it).
* matching.m:16-42 — per-feature search inside the ±2σ innovation ellipse
  with the χ²(2,95%) gate; candidate accepted by descriptor/appearance
  score.

Fixed-shape redesign: per-feature dynamic search rectangles
(matching.m:21-27) become ONE static (2R+1)² search window per feature;
positions outside the actual χ² ellipse are masked. The NCC over all
offsets for all features is a batched sliding-window reduction — extracted
windows via dynamic slices, correlation as grouped convolutions.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from ekf_slam_tpu.filter.association import mahalanobis2

# NCC lowering form (A/B knob; see ncc_scores_all): "conv" = grouped
# VALID convolutions (the default), "shift" = t² shift-multiply-adds +
# integral-image norms, "im2col" = one shaped gather + fused
# multiply-reduce, "plane" (match_all only) = full-image im2col + ONE
# dense matmul against ALL templates — the frame is unbatched under the
# instance vmap, so the im2col and the norm planes are built once per
# frame for the whole batch and the correlation becomes a single
# (H·W, t²) x (t², B·CAP) dot instead of B·CAP tiny grouped-conv passes.
# Which form is fastest on the GPU is not measured yet.
_FORM = os.environ.get("EKF_NCC", "conv")

# Grouped-conv matmul precision. Grayscale NCC in [-1, 1] against a 0.5
# acceptance threshold does not need full f32 products: "default" (TF32
# on GPU tensor cores, ~1e-3 score noise) is the default; set
# EKF_NCC_PREC=highest for f32-exact scores. The pixels bench's tracking
# gate bounds the effect.
_PREC = {"highest": jax.lax.Precision.HIGHEST,
         "high": jax.lax.Precision.HIGH,
         "default": jax.lax.Precision.DEFAULT}[
    os.environ.get("EKF_NCC_PREC", "default")]


def extract_patch(img: jnp.ndarray, center_uv: jnp.ndarray,
                  half: int) -> jnp.ndarray:
    """(2h+1)² patch around (u, v) with border clamping. Traced center."""
    return extract_patch_anchored(img, center_uv, half)[0]


def extract_patch_anchored(img: jnp.ndarray, center_uv: jnp.ndarray,
                           half: int):
    """Like extract_patch but also returns the clamped top-left anchor
    (u0, v0) actually used — near the border it differs from
    round(center)−half, and any pixel coordinate derived from the patch
    must come from the anchor, not from the requested center."""
    H, W = img.shape
    size = 2 * half + 1
    u0 = jnp.clip(jnp.round(center_uv[0]).astype(jnp.int32) - half,
                  0, W - size)
    v0 = jnp.clip(jnp.round(center_uv[1]).astype(jnp.int32) - half,
                  0, H - size)
    return jax.lax.dynamic_slice(img, (v0, u0), (size, size)), u0, v0


def _boxsum(x: jnp.ndarray, t: int, R2: int) -> jnp.ndarray:
    """Per-offset t×t patch sums of (..., W2, W2) windows via integral
    images: two prefix-sum scans + four static slices, no convolution."""
    ii = jnp.cumsum(jnp.cumsum(x, axis=-2), axis=-1)
    ii = jnp.pad(ii, ((0, 0),) * (x.ndim - 2) + ((1, 0), (1, 0)))
    return (ii[..., t:t + R2, t:t + R2]
            - ii[..., 0:R2, t:t + R2]
            - ii[..., t:t + R2, 0:R2]
            + ii[..., 0:R2, 0:R2])


def ncc_scores(window: jnp.ndarray, template: jnp.ndarray) -> jnp.ndarray:
    """Zero-mean NCC of `template` (t, t) against every offset of `window`
    ((t+2R) x (t+2R)) -> (2R+1, 2R+1) scores in [-1, 1] (crosscorr.m:14-27).
    """
    return ncc_scores_all(window[None], template[None])[0]


def ncc_scores_all(windows: jnp.ndarray,
                   templates: jnp.ndarray) -> jnp.ndarray:
    """Zero-mean NCC of per-feature templates (C, t, t) against every
    offset of per-feature windows (C, t+2R, t+2R) -> (C, 2R+1, 2R+1).

    Fast-NCC: the numerator needs no patch means (they drop out because
    Σ tm = 0) and the per-offset patch norms come from window sums /
    sums-of-squares — never the (R2, R2, t, t) patch materialization
    (the round-1 sliding-gather form tile-padded to ~27 GB at the
    pixels-bench operating point B=64, CAP=100, R=12, t=13).

    EKF_NCC selects the numerator lowering: "conv" grouped VALID
    convolution — the DEFAULT; "shift" t² fused FMA chain; "im2col"
    shaped-gather + fused multiply-reduce. All pinned equal in tests
    (2e-4, identical argmax)."""
    C, t, _ = templates.shape
    n = t * t
    dt = windows.dtype
    W2 = windows.shape[-1]
    R2 = W2 - t + 1
    tm = templates - jnp.mean(templates, axis=(-2, -1), keepdims=True)
    tnorm = jnp.sqrt(jnp.sum(tm * tm, axis=(-2, -1)) + 1e-12)   # (C,)

    if _FORM == "im2col":
        # ONE shaped gather builds patches in a (t, t, C, R2²) layout —
        # the two MINOR dims are (C, R2²) (pad ~1.07x, vs the naive
        # (C,R2,R2,t,t) whose (t,t) minor dims tile-pad ~20x = the
        # round-1 "27 GB" form) — then the correlation is a single fused
        # multiply-reduce over the two MAJOR (tap) axes: every patch
        # element is read exactly once, no grouped conv, f32-exact.
        oy, ox = jnp.meshgrid(jnp.arange(R2), jnp.arange(R2),
                              indexing="ij")
        offs = jnp.stack([oy.reshape(-1), ox.reshape(-1)], -1)  # (R2²,2)
        starts = jnp.concatenate([
            jnp.broadcast_to(jnp.arange(C)[:, None, None],
                             (C, R2 * R2, 1)),
            jnp.broadcast_to(offs[None], (C, R2 * R2, 2))], -1)
        gdn = jax.lax.GatherDimensionNumbers(
            offset_dims=(0, 1), collapsed_slice_dims=(0,),
            start_index_map=(0, 1, 2))
        patches = jax.lax.gather(
            windows, starts, gdn, slice_sizes=(1, t, t))  # (t,t,C,R2²)
        corr = jnp.sum(patches * tm.transpose(1, 2, 0)[:, :, :, None],
                       axis=(0, 1)).reshape(C, R2, R2)
        box = _boxsum(windows, t, R2)
        sq = _boxsum(windows * windows, t, R2)
        var = jnp.maximum(sq - box * box / n, 0.0)
        return corr / (jnp.sqrt(var + 1e-12) * tnorm[..., None, None])
    if _FORM == "shift":
        # Shift-and-FMA correlation: t² static-slice multiply-adds over
        # the (C, R2, R2) output — pure fused elementwise work. Per-offset
        # patch sums/norms come from two integral images (exclusive 2-D
        # prefix sums + four static slices) instead of box-filter
        # convolutions.
        corr = jnp.zeros(windows.shape[:-2] + (R2, R2), dt)
        for dy in range(t):
            for dx in range(t):
                corr = corr + (windows[..., dy:dy + R2, dx:dx + R2]
                               * tm[..., dy, dx][..., None, None])
        box = _boxsum(windows, t, R2)
        sq = _boxsum(windows * windows, t, R2)
        var = jnp.maximum(sq - box * box / n, 0.0)
        return corr / (jnp.sqrt(var + 1e-12)
                       * tnorm[..., None, None])        # (C, R2, R2)

    lhs = windows.transpose(1, 2, 0)[None]              # (1, W, W, C)
    dn = jax.lax.conv_dimension_numbers(
        lhs.shape, (t, t, 1, C), ("NHWC", "HWIO", "NHWC"))

    def gconv(x, k):
        return jax.lax.conv_general_dilated(
            x, k, (1, 1), "VALID", dimension_numbers=dn,
            feature_group_count=C,
            precision=_PREC)[0]                         # (R2, R2, C)

    corr = gconv(lhs, tm.transpose(1, 2, 0)[:, :, None, :])
    ones = jnp.ones((t, t, 1, C), dt)
    box = gconv(lhs, ones)
    sq = gconv(lhs * lhs, ones)
    var = jnp.maximum(sq - box * box / n, 0.0)
    scores = corr / (jnp.sqrt(var + 1e-12) * tnorm[None, None, :])
    return scores.transpose(2, 0, 1)                    # (C, R2, R2)


def crosscorr(a: jnp.ndarray, b: jnp.ndarray, svd: bool = False):
    """Scalar zero-mean NCC of two equal-size patches (crosscorr.m:14-27),
    or the rotation-invariant SVD variant when `svd=True` (crosscorr.m's
    third-arg mode). Batched over leading axes: a, b: (..., h, w) ->
    (...,). Uses population (flag=1) normalization like the reference."""
    if svd:
        return crosscorr_svd(a, b)
    am = a - jnp.mean(a, axis=(-2, -1), keepdims=True)
    bm = b - jnp.mean(b, axis=(-2, -1), keepdims=True)
    num = jnp.sum(am * bm, axis=(-2, -1))
    den = jnp.sqrt(jnp.sum(am * am, axis=(-2, -1))
                   * jnp.sum(bm * bm, axis=(-2, -1)))
    return jnp.where(den > 0, num / jnp.where(den > 0, den, 1.0), 0.0)


def crosscorr_svd(a: jnp.ndarray, b: jnp.ndarray):
    """Rotation-invariant patch similarity: the correlation coefficient of
    the two patches' singular-value spectra (crosscorrsvd, crosscorr.m:29-42
    — singular values are invariant to in-plane rotation/reflection of the
    patch). Batched over leading axes; population normalization."""
    d1 = jnp.linalg.svd(a, compute_uv=False)
    d2 = jnp.linalg.svd(b, compute_uv=False)
    d1m = d1 - jnp.mean(d1, axis=-1, keepdims=True)
    d2m = d2 - jnp.mean(d2, axis=-1, keepdims=True)
    # score = mean_i[(d1_i-m1)(d2_i-m2)] / (std1*std2): the population
    # Pearson correlation of the spectra (den==0 -> 0, as the reference).
    num = jnp.mean(d1m * d2m, axis=-1)
    den = jnp.sqrt(jnp.mean(d1m * d1m, axis=-1)
                   * jnp.mean(d2m * d2m, axis=-1))
    return jnp.where(den > 0, num / jnp.where(den > 0, den, 1.0), 0.0)


def _select_candidate(scores: jnp.ndarray, u0: jnp.ndarray, v0: jnp.ndarray,
                      h_pred: jnp.ndarray, S: jnp.ndarray, half_t: int,
                      chi2_gate: float, min_ncc: float, dtype):
    """χ²-gated argmax over one feature's (2R+1, 2R+1) score window.

    Candidate pixel coordinates come from the CLAMPED window anchor: near
    the border the window shifts inside the image, so offset (bx, by)
    lands the template center at (u0+half_t+bx, v0+half_t+by) — deriving
    z from h_pred + offset there would bias the measurement by the clamp
    amount (up to R+half_t px) and could even leave the image. The
    innovation used for the chi^2 gate is measured against h_pred from
    the same true candidate positions (matching.m keeps its search
    coordinates in the image frame throughout, matching.m:21-38)."""
    k = jnp.arange(scores.shape[-1], dtype=dtype)
    cu = u0.astype(dtype) + half_t + k                   # candidate u coords
    cv = v0.astype(dtype) + half_t + k                   # candidate v coords
    du, dv = jnp.meshgrid(cu - h_pred[0], cv - h_pred[1], indexing="xy")
    nu = jnp.stack([du, dv], axis=-1)                    # true innovation
    gate = mahalanobis2(nu, S) < chi2_gate               # χ² ellipse mask
    masked = jnp.where(gate, scores, -jnp.inf)
    best = jnp.argmax(masked)
    by, bx = best // scores.shape[1], best % scores.shape[1]
    score = masked[by, bx]
    z = jnp.stack([cu[bx], cv[by]])
    found = jnp.isfinite(score) & (score > min_ncc)
    return z, jnp.where(jnp.isfinite(score), score, -1.0), found


def match_feature(img: jnp.ndarray, template: jnp.ndarray,
                  h_pred: jnp.ndarray, S: jnp.ndarray, chi2_gate: float,
                  search_radius: int, min_ncc: float):
    """One feature's NCC search (matching.m re-design).

    img: (H, W) grayscale in [0,1]; template: (t, t) predicted appearance;
    h_pred: (2,) predicted pixel; S: (2, 2) innovation covariance.
    Returns (z (2,), score (), found ()).
    """
    t = template.shape[-1]
    half_t = t // 2
    win, u0, v0 = extract_patch_anchored(img, h_pred, search_radius + half_t)
    scores = ncc_scores(win, template)                   # (2R+1, 2R+1)
    return _select_candidate(scores, u0, v0, h_pred, S, half_t,
                             chi2_gate, min_ncc, img.dtype)


def ncc_scores_plane(img: jnp.ndarray, templates: jnp.ndarray,
                     h_pred: jnp.ndarray, search_radius: int):
    """Full-image NCC for all features at once (EKF_NCC=plane).

    The windowed forms above evaluate only each feature's (2R+1)² offsets
    but lower to one tiny pass per feature (grouped conv) or to
    elementwise chains. Here the correlation numerator is computed for
    EVERY valid template anchor of the frame as ONE dense matmul:

      im2col(img): (Yv·Xv, t²)   — t² static slices of the SHARED frame;
      corr = im2col @ tmᵀ:       (Yv·Xv, t²) x (t², C) matmul.

    Under the per-instance vmap the frame operand is unbatched, so XLA
    builds the im2col and the box/variance planes ONCE per frame and the
    dot batches to (Yv·Xv, t²) x (t², B·C) — one wide matmul instead of
    B·C one-channel passes. ~112x more MACs than the windowed search
    (70k anchors vs 625 per feature) in exchange for one large matmul.
    Per-feature (2R+1)² score windows are then gathered at the SAME
    clamped anchors as extract_patch_anchored, so the candidate set —
    and hence match_all's output — is identical to the windowed forms.

    Returns (scores (C, 2R+1, 2R+1), u0 (C,), v0 (C,)).
    """
    C, t, _ = templates.shape
    H, W = img.shape
    n = t * t
    half_t = t // 2
    R = search_radius
    Yv, Xv = H - t + 1, W - t + 1        # valid template-anchor plane
    size = t + 2 * R                     # windowed-form window size
    W2s = 2 * R + 1
    u0 = jnp.clip(jnp.round(h_pred[:, 0]).astype(jnp.int32) - (R + half_t),
                  0, W - size)
    v0 = jnp.clip(jnp.round(h_pred[:, 1]).astype(jnp.int32) - (R + half_t),
                  0, H - size)
    tm = templates - jnp.mean(templates, axis=(-2, -1), keepdims=True)
    tnorm = jnp.sqrt(jnp.sum(tm * tm, axis=(-2, -1)) + 1e-12)   # (C,)

    cols = jnp.stack([img[dy:dy + Yv, dx:dx + Xv]
                      for dy in range(t) for dx in range(t)],
                     axis=-1)                            # (Yv, Xv, t²)
    corr = jax.lax.dot_general(
        cols.reshape(Yv * Xv, n), tm.reshape(C, n).T,
        (((1,), (0,)), ((), ())),
        precision=_PREC).reshape(Yv, Xv, C)
    # Shared per-anchor patch sums / sums-of-squares: one reduction over
    # the tap axis (identical summands to the windowed _boxsum forms).
    box = jnp.sum(cols, axis=-1)                         # (Yv, Xv)
    sq = jnp.sum(cols * cols, axis=-1)
    var = jnp.maximum(sq - box * box / n, 0.0)

    # Per-feature (2R+1)² windows at the clamped anchors. corr is batched
    # under the instance vmap (one relayout copy — cheap next to the
    # grouped conv it replaces); var is unbatched (batched-indices gather).
    starts3 = jnp.stack([v0, u0, jnp.arange(C, dtype=jnp.int32)], axis=-1)
    gdn3 = jax.lax.GatherDimensionNumbers(
        offset_dims=(1, 2), collapsed_slice_dims=(2,),
        start_index_map=(0, 1, 2))
    win_corr = jax.lax.gather(corr, starts3, gdn3,
                              slice_sizes=(W2s, W2s, 1))  # (C, W2s, W2s)
    starts2 = jnp.stack([v0, u0], axis=-1)
    gdn2 = jax.lax.GatherDimensionNumbers(
        offset_dims=(1, 2), collapsed_slice_dims=(),
        start_index_map=(0, 1))
    win_var = jax.lax.gather(var, starts2, gdn2,
                             slice_sizes=(W2s, W2s))      # (C, W2s, W2s)
    scores = win_corr / (jnp.sqrt(win_var + 1e-12)
                         * tnorm[:, None, None])
    return scores, u0, v0


def match_all(img: jnp.ndarray, templates: jnp.ndarray, h_pred: jnp.ndarray,
              S: jnp.ndarray, visible: jnp.ndarray, chi2_gate: float,
              search_radius: int, min_ncc: float):
    """All-feature NCC search. Returns (z (CAP,2), score, found).

    EKF_NCC=plane routes through the full-image matmul form; every other
    form extracts per-feature windows and scores them (vmapped
    match_feature). Output is identical across forms (pinned in
    tests/test_vision.py)."""
    if _FORM == "plane":
        t = templates.shape[-1]
        scores, u0, v0 = ncc_scores_plane(img, templates, h_pred,
                                          search_radius)
        z, score, found = jax.vmap(
            lambda sc, a, b, h, s: _select_candidate(
                sc, a, b, h, s, t // 2, chi2_gate, min_ncc, img.dtype)
        )(scores, u0, v0, h_pred, S)
    else:
        z, score, found = jax.vmap(
            lambda tmpl, h, s: match_feature(
                img, tmpl, h, s, chi2_gate, search_radius, min_ncc)
        )(templates, h_pred, S)
    return z, score, found & visible
