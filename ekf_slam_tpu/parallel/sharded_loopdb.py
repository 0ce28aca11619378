"""Capacity-sharded loop-closure database (multi-chip retrieval).

The reference's loop database grows unboundedly on the HOST — a Python
list appended per frame and rescanned with numpy per query
(close_kitti_loops.py:106-109). The single-device redesign is a
fixed-capacity device ring (models/loopclosure.py) whose size is bounded
by one device's memory: each frame stores a global descriptor plus per-frame
keypoint descriptors (the dominant term — num_kp x kp_dim floats).

This module shards that ring over a mesh axis so capacity scales with
the number of chips:

* every device owns ``capacity / n_devices`` contiguous slots of all ring
  arrays (descr / kp_yx / kp_descr / pose / frame_id);
* **push** writes the one owning shard (a masked static-shape write —
  slot ownership is ``slot // n_local``);
* **query** is the classic distributed nearest-neighbor reduction:
  local masked cosine matmul -> local top-k, then ONE ``all_gather`` of
  the per-shard top-k candidate packets (similarity, slot, frame id,
  keypoints, pose) -> global top-k over the ``n_devices * top_k`` pool.
  Per-shard top-k >= global top-k, so the union always contains the true
  global top-k: results are identical to the single-device query up to
  tie order (pinned in tests/test_parallel.py).

Geometric verification (ratio-test + 8-point RANSAC) runs replicated on
the gathered candidates — it touches only ``top_k`` small keypoint arrays,
so replicating it costs less than a second collective round-trip.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ekf_slam_tpu.models import loopclosure as lc
from ekf_slam_tpu.models.keypoints import Keypoints, ratio_test_matches


def shard_db(db: lc.LoopDatabase, mesh: Mesh,
             axis: str = "data") -> lc.LoopDatabase:
    """Place the ring arrays shard-axis-0 over `axis`; scalars replicated.

    capacity must divide evenly by the mesh axis size."""
    ndev = mesh.shape[axis]
    cap = db.descr.shape[0]
    if cap % ndev != 0:
        raise ValueError(f"capacity {cap} not divisible by mesh axis "
                         f"'{axis}' size {ndev}")

    def place(a):
        spec = P(axis, *([None] * (a.ndim - 1))) if a.ndim >= 1 else P()
        return jax.device_put(a, NamedSharding(mesh, spec))

    return lc.LoopDatabase(
        descr=place(db.descr), kp_yx=place(db.kp_yx),
        kp_descr=place(db.kp_descr), pose=place(db.pose),
        frame_id=place(db.frame_id),
        count=jax.device_put(db.count, NamedSharding(mesh, P())),
        streak=jax.device_put(db.streak, NamedSharding(mesh, P())),
        last_match=jax.device_put(db.last_match, NamedSharding(mesh, P())))


def push(db: lc.LoopDatabase, descr: jnp.ndarray, kp: Keypoints,
         pose: jnp.ndarray, mesh: Mesh,
         axis: str = "data") -> lc.LoopDatabase:
    """Sharded ring append: the owning shard masks-in the write.

    Same ring semantics as loopclosure.push (slot = count % capacity,
    frame_id = count)."""
    cap = db.descr.shape[0]
    ndev = mesh.shape[axis]
    n_loc = cap // ndev

    @jax.shard_map(
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis),
                  P(), P(), P(), P()),
        out_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P()))
    def write(descr_s, kp_yx_s, kp_descr_s, pose_s, fid_s,
              count, q, kyx, kdescr_pose):
        kdescr, ps = kdescr_pose
        slot = count % cap
        li = slot - jax.lax.axis_index(axis) * n_loc
        mine = (li >= 0) & (li < n_loc)
        li = jnp.clip(li, 0, n_loc - 1)

        def put(arr, val):
            return arr.at[li].set(
                jnp.where(mine, val.astype(arr.dtype), arr[li]))

        return (put(descr_s, q), put(kp_yx_s, kyx),
                put(kp_descr_s, kdescr), put(pose_s, ps),
                put(fid_s, count), count + 1)

    d, kyx, kd, ps, fid, count = write(
        db.descr, db.kp_yx, db.kp_descr, db.pose, db.frame_id,
        db.count, descr, kp.yx, (kp.descr, pose))
    return db.replace(descr=d, kp_yx=kyx, kp_descr=kd, pose=ps,
                      frame_id=fid, count=count)


def query(db: lc.LoopDatabase, descr: jnp.ndarray, kp: Keypoints,
          cfg: lc.LoopConfig, key: jax.Array, mesh: Mesh,
          axis: str = "data") -> lc.QueryResult:
    """Distributed retrieval + replicated geometric verification.

    Matches loopclosure.query slot-for-slot (same gates, same RNG layout
    for the verification RANSAC) up to top-k tie order."""
    cap = db.descr.shape[0]
    ndev = mesh.shape[axis]
    n_loc = cap // ndev
    k = cfg.top_k
    # A shard can contribute at most its n_loc slots to the global top-k,
    # so gathering min(k, n_loc) per shard is still exact.
    k_loc = min(k, n_loc)
    if ndev * k_loc < k:
        raise ValueError(f"top_k {k} exceeds capacity {cap}")

    @jax.shard_map(
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(), P()),
        # all_gather makes every output bitwise-identical across the axis,
        # but the varying-mesh-axes check can't infer that statically.
        out_specs=P(), check_vma=False)
    def retrieve(descr_s, kp_yx_s, kp_descr_s, pose_s, fid_s, count, q):
        age = count - 1 - fid_s
        valid = (fid_s >= 0) & (age >= cfg.exclude_recent)
        sims = jnp.where(valid, descr_s @ q, -jnp.inf)      # local matmul
        top_sims, top_loc = jax.lax.top_k(sims, k_loc)      # local top-k
        slots = top_loc + jax.lax.axis_index(axis) * n_loc
        pack = (top_sims, slots, fid_s[top_loc], kp_yx_s[top_loc],
                kp_descr_s[top_loc], pose_s[top_loc])
        g = jax.lax.all_gather(pack, axis)        # (ndev, k_loc, ...) each
        return jax.tree.map(
            lambda a: a.reshape((ndev * k_loc,) + a.shape[2:]), g)

    sims_all, slots_all, fids_all, kp_yx_all, kp_descr_all, pose_all = \
        retrieve(db.descr, db.kp_yx, db.kp_descr, db.pose, db.frame_id,
                 db.count, descr)

    top_sims, idx = jax.lax.top_k(sims_all, k)              # global top-k

    def verify(i, kk):
        idx2, ok = ratio_test_matches(kp.descr, kp_descr_all[i], cfg.ratio)
        return lc.fundamental_ransac(
            kp.yx, kp_yx_all[i][idx2], ok, cfg, kk)

    inliers = jax.vmap(verify)(idx, jax.random.split(key, k))
    gate = (top_sims > cfg.sim_threshold) & (inliers >= cfg.min_inliers)
    score = jnp.where(gate, inliers, -1)
    best = jnp.argmax(score)
    return lc.QueryResult(
        candidate_ids=slots_all[idx], similarities=top_sims,
        best_slot=slots_all[idx[best]], best_id=fids_all[idx[best]],
        best_inliers=inliers[best], is_hypothesis=jnp.any(gate))


def best_pose(db: lc.LoopDatabase, best_slot: jnp.ndarray, mesh: Mesh,
              axis: str = "data") -> jnp.ndarray:
    """Fetch the matched frame's stored pose from its owning shard
    (loop_fusion needs it to form the relative-pose constraint)."""
    cap = db.descr.shape[0]
    n_loc = cap // mesh.shape[axis]

    @jax.shard_map(mesh=mesh, in_specs=(P(axis), P()), out_specs=P())
    def fetch(pose_s, slot):
        li = slot - jax.lax.axis_index(axis) * n_loc
        mine = (li >= 0) & (li < n_loc)
        row = pose_s[jnp.clip(li, 0, n_loc - 1)]
        return jax.lax.psum(jnp.where(mine, row, 0.0), axis)

    return fetch(db.pose, best_slot)
