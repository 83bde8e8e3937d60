"""Fixed-capacity structure-of-arrays landmark table.

Array-native replacement for the reference's `vector<LandMarkInFrame>` inside
CameraFrame (/root/reference/src/processing/camera_frame.h:11-83,
landmark.h:8-36).  The reference mutates a dynamically-sized vector per frame
(erase outliers, push new detections); here the table has a static number of
slots with an `active` mask, so the entire frontend state is one fixed-shape
pytree that lives on device across frames.

Slot lifecycle: detect → fill empty slot → tracked each frame (uv updated,
age += 1) → killed by LK failure / geometric gates (active = False) → slot
reused by the next redetection.  Compaction never moves live slots (ids are
stable), mirroring the reference's per-landmark int64 ids
(landmark.cpp:3-9, ids start at 100).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..geometry import se3 as se3m, so3
from ..geometry.se3 import SE3


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LandmarkTable:
    uv: jax.Array          # (N, 2) current pixel position in cam0
    p_w: jax.Array         # (N, 3) world position (valid iff has_3d)
    has_3d: jax.Array      # (N,) bool
    active: jax.Array      # (N,) bool — slot occupied
    inlier: jax.Array      # (N,) bool — survived this frame's gates
    age: jax.Array         # (N,) int32 frames tracked
    lm_id: jax.Array       # (N,) int32 global landmark id (-1 = empty)
    # Latest stereo measurement: right-image u coordinate (u_r = u - disparity)
    # — exported to the window BA as a scale-fixing stereo residual.
    ur: jax.Array          # (N,)
    ur_ok: jax.Array       # (N,) bool — fresh stereo measurement this frame
    # Depth bootstrap/integrity: a slot only gains 3D after two consistent
    # stereo measurements, and loses it after repeated inconsistent ones.
    z_pend: jax.Array      # (N,) pending first depth measurement
    pend_ok: jax.Array     # (N,) bool
    rej_count: jax.Array   # (N,) i32 consecutive innovation rejections
    # First observation, kept for motion triangulation
    # (LandMarkInFrame stores first-obs pose+pixel, landmark.h:21-28).
    obs0_uv: jax.Array     # (N, 2)
    obs0_q: jax.Array      # (N, 4) T_c_w quaternion at first obs
    obs0_t: jax.Array      # (N, 3)

    @property
    def capacity(self) -> int:
        return self.uv.shape[0]

    def obs0_pose(self) -> SE3:
        return SE3(self.obs0_q, self.obs0_t)


def empty(num_slots: int, dtype=jnp.float32) -> LandmarkTable:
    return LandmarkTable(
        uv=jnp.zeros((num_slots, 2), dtype),
        p_w=jnp.zeros((num_slots, 3), dtype),
        has_3d=jnp.zeros(num_slots, bool),
        active=jnp.zeros(num_slots, bool),
        inlier=jnp.zeros(num_slots, bool),
        age=jnp.zeros(num_slots, jnp.int32),
        lm_id=jnp.full(num_slots, -1, jnp.int32),
        ur=jnp.zeros(num_slots, dtype),
        ur_ok=jnp.zeros(num_slots, bool),
        z_pend=jnp.zeros(num_slots, dtype),
        pend_ok=jnp.zeros(num_slots, bool),
        rej_count=jnp.zeros(num_slots, jnp.int32),
        obs0_uv=jnp.zeros((num_slots, 2), dtype),
        obs0_q=jnp.tile(jnp.asarray([1.0, 0, 0, 0], dtype), (num_slots, 1)),
        obs0_t=jnp.zeros((num_slots, 3), dtype),
    )


def fill_new_detections(table: LandmarkTable, cand_uv, cand_valid, T_c_w: SE3,
                        next_id) -> tuple[LandmarkTable, jax.Array]:
    """Assign detection candidates to empty slots (FeatureDEM::redetect's
    fillIntoRegion equivalent, feature_dem.cpp:92-213) — fully vectorised.

    The j-th surviving candidate (by order) goes into the j-th empty slot.
    Returns the updated table and the new next_id counter.
    """
    n = table.capacity
    m = cand_uv.shape[0]

    # Rank empty slots: stable order of indices with empty first.
    empty_rank = jnp.cumsum(~table.active) - 1          # rank among empties
    num_empty = jnp.sum(~table.active)
    # Rank candidates among valid ones.
    cand_rank = jnp.cumsum(cand_valid) - 1
    take = cand_valid & (cand_rank < num_empty)

    # Build slot→candidate mapping: scatter candidate index to the slot whose
    # empty_rank equals cand_rank.
    # slot_for_cand[j] = index of the (cand_rank[j])-th empty slot.
    empty_slots = jnp.nonzero(~table.active, size=n, fill_value=n)[0]  # padded
    slot_for_cand = empty_slots[jnp.clip(cand_rank, 0, n - 1)]
    slot_for_cand = jnp.where(take, slot_for_cand, n)   # n = dump row

    def scatter(dst, src):
        pad = jnp.zeros((1,) + dst.shape[1:], dst.dtype)
        return jnp.concatenate([dst, pad], 0).at[slot_for_cand].set(src)[:-1]

    new_ids = next_id + cand_rank.astype(jnp.int32)
    q0 = jnp.broadcast_to(T_c_w.q, (m, 4))
    t0 = jnp.broadcast_to(T_c_w.t, (m, 3))

    updated = LandmarkTable(
        uv=scatter(table.uv, cand_uv),
        p_w=scatter(table.p_w, jnp.zeros((m, 3), table.p_w.dtype)),
        has_3d=scatter(table.has_3d, jnp.zeros(m, bool)),
        active=scatter(table.active, jnp.ones(m, bool)),
        inlier=scatter(table.inlier, jnp.ones(m, bool)),
        age=scatter(table.age, jnp.zeros(m, jnp.int32)),
        lm_id=scatter(table.lm_id, new_ids),
        ur=scatter(table.ur, jnp.zeros(m, table.ur.dtype)),
        ur_ok=scatter(table.ur_ok, jnp.zeros(m, bool)),
        z_pend=scatter(table.z_pend, jnp.zeros(m, table.z_pend.dtype)),
        pend_ok=scatter(table.pend_ok, jnp.zeros(m, bool)),
        rej_count=scatter(table.rej_count, jnp.zeros(m, jnp.int32)),
        obs0_uv=scatter(table.obs0_uv, cand_uv),
        obs0_q=scatter(table.obs0_q, q0),
        obs0_t=scatter(table.obs0_t, t0),
    )
    return updated, next_id + jnp.sum(take).astype(jnp.int32)


def kill(table: LandmarkTable, dead_mask) -> LandmarkTable:
    """Deactivate slots (the reference erases outlier LandMarkInFrame entries,
    camera_frame.cpp:43-91; we just clear the mask)."""
    keep = table.active & ~dead_mask
    return dataclasses.replace(table, active=keep, inlier=table.inlier & keep)


def num_active(table: LandmarkTable):
    return jnp.sum(table.active)


def num_tracked_3d(table: LandmarkTable):
    return jnp.sum(table.active & table.has_3d & table.inlier)
