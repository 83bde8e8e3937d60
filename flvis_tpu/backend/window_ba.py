"""Sliding-window structure-and-motion bundle adjustment.

Array-native replacement for the reference's LocalMapNodeletClass + PoseLMBag +
g2o (/root/reference/src/backend/vo_localmap.cpp:87-380, poselmbag.cpp:5-208):
a window of `window_size` keyframe poses (default 10, oldest fixed) and the
landmarks they observe, optimized with Levenberg-Marquardt where landmark
blocks are eliminated by a Schur complement — the batched-array equivalent of
g2o's BlockSolver_6_3 with `setMarginalized(true)` landmarks
(vo_localmap.cpp:127-216).

Data layout (all fixed shape, lives on device):
  poses      (W, ·)  ring buffer — adding the (W+1)-th keyframe overwrites the
                     oldest slot, exactly PoseLMBag::addPose's covering ring
                     (poselmbag.cpp:110-136)
  landmarks  (L, ·)  slot table keyed by global landmark id; slots whose
                     observation count drops to zero are freed (the
                     refcounting of addLMObservation/removeLMObservation)
  obs        (W, L)  dense masked observation matrix (uv + valid).  W·L is
                     small (10×1024), so dense-masked beats sparse indexing.

The LM schedule mirrors the reference: optimize(12) → cull chi²>thr edges →
optimize(8) (vo_localmap.cpp:292-319), then export the newest pose, the
positions of landmarks with ≥ min_views views (vo_localmap.cpp:320-357), and
outlier ids — the CorrectionInf feedback message equivalent.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import BackendConfig
from ..geometry import se3 as se3m, so3
from ..geometry.camera import StereoCamera, project
from ..geometry.se3 import SE3


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class WindowState:
    kf_q: jax.Array         # (W, 4) T_c_w rotation
    kf_t: jax.Array         # (W, 3)
    kf_frame_id: jax.Array  # (W,) i32, -1 = empty
    kf_valid: jax.Array     # (W,) bool
    lm_pw: jax.Array        # (L, 3)
    lm_id: jax.Array        # (L,) i32, -1 = empty
    lm_valid: jax.Array     # (L,) bool
    obs_uv: jax.Array       # (W, L, 2)
    obs_ur: jax.Array       # (W, L) right-image u for stereo residuals
    obs_ur_valid: jax.Array  # (W, L) bool
    obs_valid: jax.Array    # (W, L) bool
    head: jax.Array         # i32 ring position
    count: jax.Array        # i32 number of KFs ever added (saturating at W)

    @property
    def window(self) -> int:
        return self.kf_q.shape[0]

    @property
    def capacity(self) -> int:
        return self.lm_pw.shape[0]

    def poses(self) -> SE3:
        return SE3(self.kf_q, self.kf_t)


class KeyframePacket(NamedTuple):
    """The /vo_kf wire format equivalent (msg/KeyFrame.msg: frame_id, lm ids,
    2d, 3d arrays, T_c_w — keyframe_msg.cpp:30-124), minus the images the
    reference ships (our loop-closing node receives its own feature arrays)."""

    frame_id: jax.Array   # i32
    q: jax.Array          # (4,) T_c_w
    t: jax.Array          # (3,)
    lm_id: jax.Array      # (N,) i32
    lm_uv: jax.Array      # (N, 2)
    lm_ur: jax.Array      # (N,) right-image u (stereo residual; scale anchor)
    lm_ur_mask: jax.Array  # (N,) bool — fresh stereo measurement exists
    lm_pw: jax.Array      # (N, 3)
    lm_mask: jax.Array    # (N,) bool


class Correction(NamedTuple):
    """CorrectionInf equivalent (msg/CorrectionInf.msg, correction_inf_msg.cpp:
    13-106): corrected newest-KF pose, corrected multi-view landmark
    positions, and outlier landmark ids."""

    frame_id: jax.Array
    q: jax.Array          # (4,)
    t: jax.Array          # (3,)
    lm_id: jax.Array      # (L,) i32 (-1 padding)
    lm_pw: jax.Array      # (L, 3)
    lm_mask: jax.Array    # (L,) bool
    outlier_id: jax.Array  # (L,) i32 (-1 padding)
    outlier_mask: jax.Array  # (L,) bool
    valid: jax.Array      # bool — window full & optimization ran


def null_correction(cfg: BackendConfig, dtype=jnp.float32) -> Correction:
    """A valid=False Correction with the backend's fixed shapes — the
    "no feedback pending" value carried through fused pipeline programs
    (apply_correction gates every effect on `valid`)."""
    l = cfg.max_landmarks
    return Correction(
        frame_id=jnp.asarray(-1, jnp.int32),
        q=jnp.asarray([1.0, 0, 0, 0], dtype),
        t=jnp.zeros(3, dtype),
        lm_id=jnp.full(l, -1, jnp.int32),
        lm_pw=jnp.zeros((l, 3), dtype),
        lm_mask=jnp.zeros(l, bool),
        outlier_id=jnp.full(l, -1, jnp.int32),
        outlier_mask=jnp.zeros(l, bool),
        valid=jnp.asarray(False),
    )


def empty(cfg: BackendConfig, dtype=jnp.float32) -> WindowState:
    w, l = cfg.window_size, cfg.max_landmarks
    return WindowState(
        kf_q=jnp.tile(jnp.asarray([1.0, 0, 0, 0], dtype), (w, 1)),
        kf_t=jnp.zeros((w, 3), dtype),
        kf_frame_id=jnp.full(w, -1, jnp.int32),
        kf_valid=jnp.zeros(w, bool),
        lm_pw=jnp.zeros((l, 3), dtype),
        lm_id=jnp.full(l, -1, jnp.int32),
        lm_valid=jnp.zeros(l, bool),
        obs_uv=jnp.zeros((w, l, 2), dtype),
        obs_ur=jnp.zeros((w, l), dtype),
        obs_ur_valid=jnp.zeros((w, l), bool),
        obs_valid=jnp.zeros((w, l), bool),
        head=jnp.asarray(0, jnp.int32),
        count=jnp.asarray(0, jnp.int32),
    )


@functools.partial(jax.jit, static_argnames=("cfg", "axis_name"))
def add_keyframe(cfg: BackendConfig, state: WindowState, kf: KeyframePacket,
                 axis_name: str | None = None) -> WindowState:
    """Ring-insert a keyframe and merge its landmark observations.

    Covers the window-init and slide paths of the reference
    (vo_localmap.cpp:122-284): the oldest pose slot is overwritten, its
    observations dropped, landmarks orphaned by the slide are freed, and the
    new frame's landmarks are matched to existing slots by id or allocated.

    With `axis_name` (inside shard_map, landmark axis sharded): each shard
    allocates only the packet landmarks it OWNS (lm_id mod n_shards — a
    deterministic hash partition), so a replicated packet lands each
    landmark on exactly one shard; id-matching already touches only the
    owning shard since that is where the slot was allocated.
    """
    w = state.window
    L = state.capacity
    slot = state.head

    # --- overwrite oldest pose slot -----------------------------------------
    state = dataclasses.replace(
        state,
        kf_q=state.kf_q.at[slot].set(kf.q),
        kf_t=state.kf_t.at[slot].set(kf.t),
        kf_frame_id=state.kf_frame_id.at[slot].set(kf.frame_id),
        kf_valid=state.kf_valid.at[slot].set(True),
        obs_valid=state.obs_valid.at[slot].set(False),
        obs_ur_valid=state.obs_ur_valid.at[slot].set(False),
        head=(state.head + 1) % w,
        count=jnp.minimum(state.count + 1, w),
    )

    # --- match packet landmarks to existing slots by id ---------------------
    n = kf.lm_id.shape[0]
    # (N, L) id equality (ids are unique per slot).
    eq = (kf.lm_id[:, None] == state.lm_id[None, :]) & state.lm_valid[None, :] & kf.lm_mask[:, None]
    match_slot = jnp.argmax(eq, axis=1)            # (N,)
    has_match = jnp.any(eq, axis=1)

    # --- allocate slots for unmatched landmarks -----------------------------
    need = kf.lm_mask & ~has_match
    if axis_name is not None:
        own = (kf.lm_id % jax.lax.axis_size(axis_name)) == \
            jax.lax.axis_index(axis_name)
        need = need & own
    free = ~state.lm_valid
    free_slots = jnp.nonzero(free, size=L, fill_value=L)[0]
    need_rank = jnp.cumsum(need) - 1
    num_free = jnp.sum(free)
    can_alloc = need & (need_rank < num_free)
    alloc_slot = free_slots[jnp.clip(need_rank, 0, L - 1)]

    tgt = jnp.where(has_match, match_slot, jnp.where(can_alloc, alloc_slot, L))  # L = dump

    use = kf.lm_mask & (has_match | can_alloc)
    # New slots get the packet's world position; existing keep the window's
    # current estimate (the backend owns refined positions).
    lm_pw = jnp.concatenate([state.lm_pw, jnp.zeros((1, 3), state.lm_pw.dtype)], 0)
    lm_pw = lm_pw.at[jnp.where(can_alloc & use, tgt, L)].set(kf.lm_pw)[:-1]
    lm_id = jnp.concatenate([state.lm_id, jnp.zeros((1,), jnp.int32)], 0)
    lm_id = lm_id.at[jnp.where(use, tgt, L)].set(kf.lm_id)[:-1]
    lm_valid = jnp.concatenate([state.lm_valid, jnp.zeros((1,), bool)], 0)
    lm_valid = lm_valid.at[jnp.where(use, tgt, L)].set(True)[:-1]

    obs_row_uv = jnp.zeros((L + 1, 2), state.obs_uv.dtype).at[jnp.where(use, tgt, L)].set(kf.lm_uv)[:-1]
    obs_row_valid = jnp.zeros((L + 1,), bool).at[jnp.where(use, tgt, L)].set(True)[:-1]
    obs_row_ur = jnp.zeros((L + 1,), state.obs_ur.dtype).at[jnp.where(use, tgt, L)].set(kf.lm_ur)[:-1]
    ur_use = use & kf.lm_ur_mask
    obs_row_ur_valid = jnp.zeros((L + 1,), bool).at[jnp.where(ur_use, tgt, L)].set(True)[:-1]

    obs_uv = state.obs_uv.at[slot].set(obs_row_uv)
    obs_valid = state.obs_valid.at[slot].set(obs_row_valid)
    obs_ur = state.obs_ur.at[slot].set(obs_row_ur)
    obs_ur_valid = state.obs_ur_valid.at[slot].set(obs_row_ur_valid)

    # --- free orphaned landmark slots (PoseLMBag refcount semantics) --------
    views = jnp.sum(obs_valid, axis=0)
    lm_valid = lm_valid & (views > 0)
    obs_valid = obs_valid & lm_valid[None, :]
    obs_ur_valid = obs_ur_valid & obs_valid

    return dataclasses.replace(
        state, lm_pw=lm_pw, lm_id=lm_id, lm_valid=lm_valid,
        obs_uv=obs_uv, obs_valid=obs_valid,
        obs_ur=obs_ur, obs_ur_valid=obs_ur_valid,
    )


# --- L-LAST LAYOUT --------------------------------------------------------
# All per-landmark tensors below keep the landmark axis LAST, so L (the only
# large dimension) is the contiguous, vectorised one and einsums contract
# over a 1024-deep `l` instead of batches of 3×6 blocks.


def _residuals(cam: StereoCamera, poses: SE3, lm_pw, obs_uv, obs_ur, ur_valid):
    """(W, 3, L) stereo reprojection residuals [Δu_l, Δv, Δu_r] + points
    p_c (W, 3, L).

    The third (right-camera) component is zeroed where no stereo measurement
    exists; it anchors metric scale, which the reference's monocular g2o
    edges (EdgeSE3ProjectXYZ) leave as a slow gauge drift."""
    pw = lm_pw.T if lm_pw.ndim == 2 else lm_pw            # (3, L)
    R = so3.to_matrix(poses.q)                            # (W, 3, 3)
    p_c = jnp.einsum("wab,bl->wal", R, pw,
                     precision="highest") + poses.t[:, :, None]
    x, y = p_c[:, 0], p_c[:, 1]
    z = jnp.where(jnp.abs(p_c[:, 2]) < 1e-6, 1e-6, p_c[:, 2])
    u = cam.fx * x / z + cam.cx
    v = cam.fy * y / z + cam.cy
    ur_pred = u - cam.fx * cam.baseline / z
    r = jnp.stack([
        u - obs_uv[..., 0],
        v - obs_uv[..., 1],
        jnp.where(ur_valid, ur_pred - obs_ur, 0.0),
    ], axis=1)                                            # (W, 3, L)
    return r, p_c


def _jacobians(cam: StereoCamera, poses: SE3, p_c, ur_valid):
    """J_pose (W, 3, 6, L) wrt left-retraction of each pose, and
    J_lm (W, 3, 3, L) wrt landmark world position (rows: u_l, v, u_r)."""
    x, y = p_c[:, 0], p_c[:, 1]
    zr = p_c[:, 2]
    z = jnp.where(jnp.abs(zr) < 1e-6, 1e-6, zr)
    iz = 1.0 / z
    iz2 = iz * iz
    zero = jnp.zeros_like(iz)
    one = jnp.ones_like(iz)
    urm = ur_valid.astype(p_c.dtype)
    duv = jnp.stack(
        [
            jnp.stack([cam.fx * iz, zero, -cam.fx * x * iz2], 1),
            jnp.stack([zero, cam.fy * iz, -cam.fy * y * iz2], 1),
            jnp.stack([cam.fx * iz * urm, zero,
                       (-cam.fx * x * iz2 + cam.fx * cam.baseline * iz2) * urm], 1),
        ],
        axis=1,
    )                                                     # (W, 3row, 3xyz, L)
    # [I | -hat(p_c)] rows, (W, 3xyz, 6, L).
    dp_pose = jnp.stack(
        [
            jnp.stack([one, zero, zero, zero, zr, -y], 1),
            jnp.stack([zero, one, zero, -zr, zero, x], 1),
            jnp.stack([zero, zero, one, y, -x, zero], 1),
        ],
        axis=1,
    )
    J_pose = jnp.sum(duv[:, :, :, None, :] * dp_pose[:, None, :, :, :], axis=2)
    R = so3.to_matrix(poses.q)                            # (W, 3, 3)
    J_lm = jnp.einsum("wacl,wcb->wabl", duv, R, precision="highest")
    return J_pose, J_lm


def _robust_weights(r, delta):
    r2 = jnp.sum(r * r, axis=1)                           # (W, L)
    rn = jnp.sqrt(jnp.maximum(r2, 1e-12))
    return jnp.where(rn <= delta, 1.0, delta / rn), r2


def _total_cost(r, w_mask, delta):
    r2 = jnp.sum(r * r, axis=1)
    rn = jnp.sqrt(jnp.maximum(r2, 1e-12))
    rho = jnp.where(rn <= delta, 0.5 * r2, delta * (rn - 0.5 * delta))
    return jnp.sum(jnp.where(w_mask, rho, 0.0))


def _sym3_inv(H):
    """Closed-form inverse of symmetric (3, 3, L) blocks — pure elementwise
    arithmetic over L (jnp.linalg.inv would run a batched LU over L tiny
    matrices)."""
    a, b, c = H[0, 0], H[0, 1], H[0, 2]
    d, e, f = H[1, 1], H[1, 2], H[2, 2]
    A00 = d * f - e * e
    A01 = c * e - b * f
    A02 = b * e - c * d
    A11 = a * f - c * c
    A12 = b * c - a * e
    A22 = a * d - b * b
    det = a * A00 + b * A01 + c * A02
    idet = jnp.where(jnp.abs(det) > 1e-20, 1.0 / det, 0.0)
    row0 = jnp.stack([A00, A01, A02])
    row1 = jnp.stack([A01, A11, A12])
    row2 = jnp.stack([A02, A12, A22])
    return jnp.stack([row0, row1, row2]) * idet


def _schur_step(cam, poses: SE3, lm_pw, obs, w_mask, fixed_pose, lam, delta,
                axis_name=None):
    """One damped Schur-complement LM step.  Returns (new_poses, new_lm_pw).

    With `axis_name`, the landmark dimension is assumed sharded over that
    mesh axis (shard_map): landmark blocks (Hll, A, bl, dl) stay local to
    each device, while the small pose-system partial sums (Hpp, S_red, bp —
    all (W,6,·)-sized) are reduced with psum.  This distributed bundle
    adjustment is something the reference cannot do (g2o is single
    threaded per window)."""
    obs_uv, obs_ur, ur_valid = obs
    def reduce(x):
        return jax.lax.psum(x, axis_name) if axis_name else x
    W = poses.q.shape[0]
    r, p_c = _residuals(cam, poses, lm_pw, obs_uv, obs_ur, ur_valid)
    Jp, Jl = _jacobians(cam, poses, p_c, ur_valid)    # (W,3,6,L), (W,3,3,L)
    huber, _ = _robust_weights(r, delta)
    wgt = jnp.where(w_mask, huber, 0.0)               # (W, L)

    # Zero the fixed pose's Jacobian → its delta stays 0 (gauge).
    Jp = jnp.where(fixed_pose[:, None, None, None], 0.0, Jp)

    # precision="highest": these normal-equation products are the numerical
    # backbone of the solver; a reduced-precision (TF32/bf16) pass is not
    # enough.
    hp = dict(precision="highest")
    Jpw = Jp * wgt[:, None, None, :]
    Hpp = reduce(jnp.einsum("wakl,waml->wkm", Jpw, Jp, **hp))          # (W, 6, 6)
    Hll = jnp.einsum("wabl,wl,wacl->bcl", Jl, wgt, Jl, **hp)           # (3, 3, L) local
    Hpl = jnp.einsum("wakl,wabl->wkbl", Jpw, Jl, **hp)                 # (W, 6, 3, L) local
    bp = -reduce(jnp.einsum("wakl,wal->wk", Jpw, r, **hp))             # (W, 6)
    bl = -jnp.einsum("wabl,wl,wal->bl", Jl, wgt, r, **hp)              # (3, L) local

    # Damp and invert landmark blocks (closed-form symmetric 3×3).
    tr = Hll[0, 0] + Hll[1, 1] + Hll[2, 2]
    damp = lam * jnp.maximum(tr / 3.0, 1e-6) + 1e-8
    Hll_d = Hll + damp * jnp.eye(3)[:, :, None]
    Hll_inv = _sym3_inv(Hll_d)                                         # (3, 3, L)

    # Schur complement of the landmark block.
    A = jnp.einsum("wkml,mnl->wknl", Hpl, Hll_inv, **hp)               # (W, 6, 3, L)
    S_red = reduce(jnp.einsum("wknl,vmnl->wvkm", A, Hpl, **hp))
    Hpp_d = Hpp + (lam * jnp.eye(6))[None] * jnp.maximum(
        jnp.trace(Hpp, axis1=-2, axis2=-1)[:, None, None] / 6.0, 1e-6
    )
    S = -S_red
    S = S.at[jnp.arange(W), jnp.arange(W)].add(Hpp_d)
    S = S.transpose(0, 2, 1, 3).reshape(6 * W, 6 * W)
    rhs = bp - reduce(jnp.einsum("wknl,nl->wk", A, bl, **hp))

    # Make the fixed pose's rows/cols an identity block so the solve is well-
    # posed with delta = 0 there.
    fixmat = jnp.repeat(fixed_pose, 6)
    S = jnp.where(fixmat[:, None] | fixmat[None, :], 0.0, S)
    S = S + jnp.diag(jnp.where(fixmat, 1.0, 1e-9))
    rhs = jnp.where(fixed_pose[:, None], 0.0, rhs)

    dp = jnp.linalg.solve(S, rhs.reshape(-1)).reshape(W, 6)

    # Back-substitute landmarks.
    dl = jnp.einsum("bcl,cl->bl", Hll_inv,
                    bl - jnp.einsum("wkcl,wk->cl", Hpl, dp, **hp), **hp)

    new_poses = se3m.retract_left(poses, dp)
    return new_poses, lm_pw + dl.T


def _lm_loop(cam, poses, lm_pw, obs, w_mask, fixed_pose, iters: int, delta,
             axis_name=None):
    obs_uv, obs_ur, ur_valid = obs

    def body(carry):
        it, poses, lm_pw, lam, cost, _ = carry
        new_poses, new_lm = _schur_step(cam, poses, lm_pw, obs, w_mask, fixed_pose,
                                        lam, delta, axis_name)
        r, _ = _residuals(cam, new_poses, new_lm, obs_uv, obs_ur, ur_valid)
        new_cost = _total_cost(r, w_mask, delta)
        if axis_name:
            new_cost = jax.lax.psum(new_cost, axis_name)
        better = new_cost < cost
        poses = jax.tree.map(lambda a, b: jnp.where(better, b, a), poses, new_poses)
        lm_pw = jnp.where(better, new_lm, lm_pw)
        lam = jnp.where(better, jnp.maximum(lam * 0.3, 1e-7), jnp.minimum(lam * 5.0, 1e3))
        # Converged: an ACCEPTED step improved the cost by < 1e-5 relative —
        # the same "chi² stopped moving" criterion g2o's optimize(N) uses to
        # return before N iterations; each remaining iteration would pay a
        # full Schur solve for noise-level gains.
        done = better & (cost - new_cost < 1e-5 * cost)
        cost = jnp.where(better, new_cost, cost)
        return it + 1, poses, lm_pw, lam, cost, done

    def cond(carry):
        it, _, _, _, _, done = carry
        return (it < iters) & ~done

    r0, _ = _residuals(cam, poses, lm_pw, obs_uv, obs_ur, ur_valid)
    cost0 = _total_cost(r0, w_mask, delta)
    if axis_name:
        cost0 = jax.lax.psum(cost0, axis_name)
    _, poses, lm_pw, _, cost, _ = jax.lax.while_loop(
        cond, body,
        (jnp.asarray(0, jnp.int32), poses, lm_pw, jnp.asarray(1e-4, cost0.dtype),
         cost0, jnp.asarray(False)))
    return poses, lm_pw, cost


class BAResult(NamedTuple):
    state: WindowState
    correction: Correction
    cost: jax.Array
    num_obs: jax.Array


@functools.partial(jax.jit, static_argnames=("cfg", "axis_name"))
def optimize(cfg: BackendConfig, cam: StereoCamera, state: WindowState,
             axis_name: str | None = None) -> BAResult:
    """Run the two-phase windowed BA and produce the feedback Correction.

    No-ops (valid=False correction) until the window holds ≥ 3 keyframes,
    matching the reference's UN_INITIALIZED gate (vo_localmap.cpp:100-121).

    With `axis_name` (inside shard_map): landmark arrays are shard-local;
    the pose-system partial sums are psum-reduced over the mesh axis and
    the returned Correction's landmark arrays are shard-local rows (gather
    with all_gather before feeding a replicated consumer).
    """
    poses = state.poses()
    w_mask = state.obs_valid & state.kf_valid[:, None] & state.lm_valid[None, :]

    # Oldest valid KF is the gauge anchor (vo_localmap.cpp:159-162).
    fid = jnp.where(state.kf_valid, state.kf_frame_id, jnp.iinfo(jnp.int32).max)
    fixed_pose = jnp.arange(state.window) == jnp.argmin(fid)

    obs = (state.obs_uv, state.obs_ur, state.obs_ur_valid & w_mask)
    # Phase 1.
    poses1, lm1, _ = _lm_loop(cam, poses, state.lm_pw, obs, w_mask,
                              fixed_pose, cfg.iters1, cfg.huber_delta,
                              axis_name=axis_name)
    # Edge cull: chi² > thr (vo_localmap.cpp:292-319).
    r1, _ = _residuals(cam, poses1, lm1, *obs)
    chi2 = jnp.sum(r1 * r1, axis=1)                       # (W, L)
    w_mask2 = w_mask & (chi2 < cfg.chi2_cull)
    # Phase 2.
    obs2 = (state.obs_uv, state.obs_ur, state.obs_ur_valid & w_mask2)
    poses2, lm2, cost = _lm_loop(cam, poses1, lm1, obs2, w_mask2,
                                 fixed_pose, cfg.iters2, cfg.huber_delta,
                                 axis_name=axis_name)

    ready = state.count >= 3
    poses_out = jax.tree.map(lambda a, b: jnp.where(ready, b, a), poses, poses2)
    lm_out = jnp.where(ready, lm2, state.lm_pw)

    # Landmarks that lost all observations in the cull are outliers
    # (exported as CorrectionInf outlier ids, vo_localmap.cpp:320-366).
    views_before = jnp.sum(w_mask, axis=0)
    views_after = jnp.sum(w_mask2, axis=0)
    outlier = state.lm_valid & (views_before > 0) & (views_after == 0) & ready
    obs_valid_new = jnp.where(ready, state.obs_valid & w_mask2, state.obs_valid)
    lm_valid_new = state.lm_valid & ~outlier

    new_state = dataclasses.replace(
        state,
        kf_q=poses_out.q, kf_t=poses_out.t, lm_pw=lm_out,
        obs_valid=obs_valid_new, lm_valid=lm_valid_new,
    )

    # Newest KF = slot before head.
    newest = (state.head - 1) % state.window
    multiview = lm_valid_new & (views_after >= cfg.min_views)
    corr = Correction(
        frame_id=state.kf_frame_id[newest],
        q=poses_out.q[newest], t=poses_out.t[newest],
        lm_id=jnp.where(multiview, state.lm_id, -1),
        lm_pw=lm_out,
        lm_mask=multiview,
        outlier_id=jnp.where(outlier, state.lm_id, -1),
        outlier_mask=outlier,
        valid=ready,
    )
    return BAResult(new_state, corr, cost, jnp.sum(w_mask2))


@functools.partial(jax.jit, static_argnames=("cfg",))
def reset(cfg: BackendConfig, state: WindowState) -> WindowState:
    """Full wipe — the KFMSG_CMD_RESET_LM handler (vo_localmap.cpp:89-98).

    Shape-preserving (derived from `state`, not cfg) so it also works on a
    landmark-sharded WindowState inside shard_map, where the local landmark
    axis is cfg.max_landmarks / n_shards."""
    dtype = state.lm_pw.dtype
    w, l = state.window, state.capacity
    return WindowState(
        kf_q=jnp.tile(jnp.asarray([1.0, 0, 0, 0], dtype), (w, 1)),
        kf_t=jnp.zeros((w, 3), dtype),
        kf_frame_id=jnp.full(w, -1, jnp.int32),
        kf_valid=jnp.zeros(w, bool),
        lm_pw=jnp.zeros((l, 3), dtype),
        lm_id=jnp.full(l, -1, jnp.int32),
        lm_valid=jnp.zeros(l, bool),
        obs_uv=jnp.zeros((w, l, 2), dtype),
        obs_ur=jnp.zeros((w, l), dtype),
        obs_ur_valid=jnp.zeros((w, l), bool),
        obs_valid=jnp.zeros((w, l), bool),
        head=jnp.asarray(0, jnp.int32),
        count=jnp.asarray(0, jnp.int32),
    )


def null_correction_like(state: WindowState, dtype=jnp.float32) -> Correction:
    """null_correction sized to a (possibly landmark-sharded) WindowState."""
    l = state.capacity
    return Correction(
        frame_id=jnp.asarray(-1, jnp.int32),
        q=jnp.asarray([1.0, 0, 0, 0], dtype),
        t=jnp.zeros(3, dtype),
        lm_id=jnp.full(l, -1, jnp.int32),
        lm_pw=jnp.zeros((l, 3), dtype),
        lm_mask=jnp.zeros(l, bool),
        outlier_id=jnp.full(l, -1, jnp.int32),
        outlier_mask=jnp.zeros(l, bool),
        valid=jnp.asarray(False),
    )
