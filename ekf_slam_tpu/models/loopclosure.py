"""Loop-closure retrieval ("CALC 2.0"/close_kitti_loops.py + test_net.py).

Pipeline per incoming frame (close_kitti_loops.py:100-154):
  1. push the frame's global descriptor (+ keypoints, + pose) into the DB,
  2. after `min_db` frames, query all but the most recent `exclude_recent`
     entries: cosine similarity (one matmul — close_kitti_loops.py:24 /
     test_net.py:169) -> top-K candidates,
  3. geometric verification of the best candidates: keypoint ratio-test
     matches + epipolar (fundamental-matrix) RANSAC — the cv2.BFMatcher +
     cv2.findFundamentalMat step (close_kitti_loops.py:30-57), re-built as
     a vmapped 8-point RANSAC in JAX,
  4. temporal consistency: declare a loop only after `consistency_count`
     consecutive hypotheses whose matched ids lie within an id-window
     (close_kitti_loops.py:113-138, C=7 within W=9),
  5. emit a loop constraint carrying both frames' poses
     (close_kitti_loops.py:141-143) — which feed the EKF as relative-pose
     measurements (filter/loop_fusion.py), closing the link the reference
     left open (SURVEY.md §1).

Redesign: the DB is a fixed-capacity ring buffer so the query is a
static-shape masked matmul; all verification is fixed-hypothesis-count
RANSAC under vmap.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ekf_slam_tpu.models.keypoints import Keypoints, ratio_test_matches
from ekf_slam_tpu.utils import pytree


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    capacity: int = 4096            # ring-buffer frames
    top_k: int = 7                  # close_kitti_loops.py:26 (K=7)
    exclude_recent: int = 200       # close_kitti_loops.py:108 (db[:-200])
    min_db: int = 400               # close_kitti_loops.py:107 (i > 2N=400)
    sim_threshold: float = 0.85     # cosine acceptance
    ratio: float = 0.7              # kp ratio test
    ransac_hypotheses: int = 64
    ransac_threshold: float = 2.0   # Sampson distance gate (px)
    min_inliers: int = 12
    consistency_count: int = 7      # close_kitti_loops.py:116 (C)
    consistency_window: int = 9     # close_kitti_loops.py:115 (W)


@pytree.dataclass
class LoopDatabase:
    """Fixed-capacity descriptor/keypoint/pose store."""
    descr: jnp.ndarray        # (N, D)
    kp_yx: jnp.ndarray        # (N, K, 2)
    kp_descr: jnp.ndarray     # (N, K, Dk)
    pose: jnp.ndarray         # (N, 7) [r(3), q(4)] camera pose per frame
    frame_id: jnp.ndarray     # (N,) int32 absolute frame index per slot
                              # (-1 = empty). Once count > capacity the ring
                              # wraps and slot order no longer equals frame
                              # order, so age/recency MUST come from this,
                              # not from the slot index.
    count: jnp.ndarray        # () int32 — frames pushed so far
    # temporal-consistency state (close_kitti_loops.py:113-138)
    streak: jnp.ndarray       # () int32 consecutive hypothesis count
    last_match: jnp.ndarray   # () int32 id of last hypothesis


def init_db(cfg: LoopConfig, descr_dim: int, num_kp: int,
            kp_dim: int, dtype=jnp.float32) -> LoopDatabase:
    n = cfg.capacity
    return LoopDatabase(
        descr=jnp.zeros((n, descr_dim), dtype),
        kp_yx=jnp.zeros((n, num_kp, 2), dtype),
        kp_descr=jnp.zeros((n, num_kp, kp_dim), dtype),
        pose=jnp.zeros((n, 7), dtype),
        frame_id=jnp.full((n,), -1, jnp.int32),
        count=jnp.zeros((), jnp.int32),
        streak=jnp.zeros((), jnp.int32),
        last_match=jnp.full((), -1, jnp.int32))


def push(db: LoopDatabase, descr: jnp.ndarray, kp: Keypoints,
         pose: jnp.ndarray) -> LoopDatabase:
    """Append one frame (ring semantics; the reference grows unboundedly,
    close_kitti_loops.py:106)."""
    slot = db.count % db.descr.shape[0]
    return db.replace(
        descr=db.descr.at[slot].set(descr.astype(db.descr.dtype)),
        kp_yx=db.kp_yx.at[slot].set(kp.yx.astype(db.kp_yx.dtype)),
        kp_descr=db.kp_descr.at[slot].set(
            kp.descr.astype(db.kp_descr.dtype)),
        pose=db.pose.at[slot].set(pose.astype(db.pose.dtype)),
        frame_id=db.frame_id.at[slot].set(db.count),
        count=db.count + 1)


class QueryResult(NamedTuple):
    candidate_ids: jnp.ndarray   # (top_k,) ring SLOTS (may be invalid)
    similarities: jnp.ndarray    # (top_k,)
    best_slot: jnp.ndarray       # () ring slot of the best candidate
    best_id: jnp.ndarray         # () ABSOLUTE frame index of best candidate
    best_inliers: jnp.ndarray    # () inlier count of best candidate
    is_hypothesis: jnp.ndarray   # () bool — passed sim + geometry gates


def query(db: LoopDatabase, descr: jnp.ndarray, kp: Keypoints,
          cfg: LoopConfig, key: jax.Array) -> QueryResult:
    """Retrieve + geometrically verify loop-closure candidates."""
    # Valid entries: written, and at least exclude_recent frames old. Age is
    # computed from the stored absolute frame index — after the ring wraps
    # (count > capacity) the newest frames occupy the LOWEST slots, so a
    # slot-index age would invert the recency exclusion and return near
    # self-matches (close_kitti_loops.py:108 excludes db[:-200] by frame).
    age = db.count - 1 - db.frame_id
    valid = (db.frame_id >= 0) & (age >= cfg.exclude_recent)
    sims = db.descr @ descr                  # ONE matmul (test_net.py:169)
    sims = jnp.where(valid, sims, -jnp.inf)
    top_sims, top_ids = jax.lax.top_k(sims, cfg.top_k)

    # Geometric verification of every candidate (vmapped).
    def verify(cand_id, k):
        idx2, ok = ratio_test_matches(
            kp.descr, db.kp_descr[cand_id], cfg.ratio)
        pts1 = kp.yx
        pts2 = db.kp_yx[cand_id][idx2]
        inl = fundamental_ransac(pts1, pts2, ok, cfg, k)
        return inl

    keys = jax.random.split(key, cfg.top_k)
    inliers = jax.vmap(verify)(top_ids, keys)              # (top_k,)
    gate = (top_sims > cfg.sim_threshold) & (inliers >= cfg.min_inliers)
    score = jnp.where(gate, inliers, -1)
    best = jnp.argmax(score)
    return QueryResult(
        candidate_ids=top_ids, similarities=top_sims,
        best_slot=top_ids[best], best_id=db.frame_id[top_ids[best]],
        best_inliers=inliers[best], is_hypothesis=jnp.any(gate))


def step_temporal(db: LoopDatabase, result: QueryResult,
                  cfg: LoopConfig):
    """Temporal-consistency filter (close_kitti_loops.py:113-138): a loop is
    declared after `consistency_count` consecutive frames whose hypothesis
    ids stay within `consistency_window` of each other. Returns
    (new_db, loop_declared (bool), loop_slot (int32), loop_frame (int32)).
    The id-window comparison uses ABSOLUTE frame indices (best_id), which
    stay monotone across the ring-buffer wrap; loop_slot addresses db
    arrays (pose, kp) for the matched frame."""
    near = jnp.abs(result.best_id - db.last_match) <= cfg.consistency_window
    cont = result.is_hypothesis & (near | (db.streak == 0))
    streak = jnp.where(cont, db.streak + 1, jnp.where(
        result.is_hypothesis, 1, 0))
    declared = streak >= cfg.consistency_count
    new_db = db.replace(
        streak=jnp.where(declared, 0, streak),
        last_match=jnp.where(result.is_hypothesis, result.best_id,
                             jnp.full((), -1, jnp.int32)))
    return new_db, declared, result.best_slot, result.best_id


# ------------------------------------------------------- fundamental matrix

def _normalize_pts(pts: jnp.ndarray, w: jnp.ndarray):
    """Hartley normalization with masked statistics. pts: (K, 2) as (y, x)
    -> homogeneous (K, 3) (x, y, 1) plus the 3x3 transform."""
    xy = pts[:, ::-1]
    wsum = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(xy * w[:, None], axis=0) / wsum
    d = jnp.sqrt(jnp.sum((xy - mean) ** 2, axis=-1))
    scale = jnp.sqrt(2.0) / jnp.maximum(
        jnp.sum(d * w) / wsum, 1e-6)
    T = jnp.array([[scale, 0.0, -scale * mean[0]],
                   [0.0, scale, -scale * mean[1]],
                   [0.0, 0.0, 1.0]], pts.dtype)
    xyh = jnp.concatenate([xy, jnp.ones_like(xy[:, :1])], axis=-1)
    return xyh @ T.T, T


def _eight_point(p1h, p2h, w):
    """Weighted 8-point: F = argmin ||A f|| via the smallest eigenvector of
    AᵀWA (9x9 symmetric eigendecomposition — cheap and static-shape)."""
    x1, y1 = p1h[:, 0], p1h[:, 1]
    x2, y2 = p2h[:, 0], p2h[:, 1]
    A = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                   jnp.ones_like(x1)], axis=-1)             # (K, 9)
    M = (A * w[:, None]).T @ A
    _, vecs = jnp.linalg.eigh(M)
    f = vecs[:, 0]
    F = f.reshape(3, 3)
    # Rank-2 projection via SVD of the 3x3 (trivial size).
    U, S, Vt = jnp.linalg.svd(F)
    return (U * S.at[2].set(0.0)) @ Vt


def _sampson(F, p1h, p2h):
    Fx1 = p1h @ F.T
    Ftx2 = p2h @ F
    num = jnp.sum(p2h * Fx1, axis=-1) ** 2
    den = Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2 + Ftx2[:, 0] ** 2 + Ftx2[:, 1] ** 2
    return num / jnp.maximum(den, 1e-12)


def fundamental_ransac(pts1: jnp.ndarray, pts2: jnp.ndarray,
                       valid: jnp.ndarray, cfg: LoopConfig,
                       key: jax.Array) -> jnp.ndarray:
    """Masked fixed-batch RANSAC for F (cv2.findFundamentalMat equivalent,
    close_kitti_loops.py:47). Returns the best inlier count."""
    K = pts1.shape[0]
    dtype = pts1.dtype
    p1h, T1 = _normalize_pts(pts1, valid.astype(dtype))
    p2h, T2 = _normalize_pts(pts2, valid.astype(dtype))
    # Sampson threshold transforms with the normalization scale; evaluate in
    # the ORIGINAL pixel frame instead: denormalize F.
    vf = valid.astype(dtype)

    def one(k):
        # Weighted random 8-subset: sample scores, keep top-8 among valid.
        r = jax.random.uniform(k, (K,)) + (~valid) * 1e3
        _, sel = jax.lax.top_k(-r, 8)
        w8 = jnp.zeros(K, dtype).at[sel].set(1.0) * vf
        Fn = _eight_point(p1h, p2h, w8)
        F = T2.T @ Fn @ T1
        d = _sampson(F, _h(pts1), _h(pts2))
        inl = (d < cfg.ransac_threshold ** 2) & valid
        return jnp.sum(inl)

    counts = jax.vmap(one)(jax.random.split(key, cfg.ransac_hypotheses))
    return jnp.max(counts)


def _h(pts):
    xy = pts[:, ::-1]
    return jnp.concatenate([xy, jnp.ones_like(xy[:, :1])], axis=-1)
