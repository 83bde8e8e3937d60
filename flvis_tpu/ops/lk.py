"""Batched pyramidal Lucas-Kanade optical flow.

Array-native replacement for cv::calcOpticalFlowPyrLK as used by the
reference's temporal tracker (31×31 window, OPTFLOW_USE_INITIAL_FLOW with an
IMU-projected guess — /root/reference/src/processing/lkorb_tracking.cpp:38-74)
and its stereo left→right depth tracker
(/root/reference/src/processing/camera_frame.cpp:93-180).

Design: instead of a per-point C++ loop, the whole point set is advanced
together.  Per pyramid level we precompute template-patch gradients from the
previous image (OpenCV does the same — gradients are computed once from the
prev patch and reused across iterations) and run a fixed number of
Gauss-Newton iterations with a 2×2 closed-form solve, all masked so the
computation is one static XLA program.  Converged points are frozen by a
`jnp.where` rather than an early exit.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from . import image as imops


@dataclasses.dataclass(frozen=True)
class LKParams:
    radius: int = 10          # half window; side = 2r+1 (ref uses 15 → 31×31)
    num_levels: int = 4       # pyramid levels (ref requests 10, capped by size)
    iters: int = 10           # GN iterations per level
    min_eig: float = 1e-4     # min eigenvalue of H per pixel (OpenCV default)
    eps: float = 0.01         # convergence threshold on |delta| (OpenCV default)
    search_margin: int = 8    # px the flow may drift within one level's window


def _selection(rel, size: int, width: int):
    """Bilinear row/column selection matrices, (N, size, width).

    rel: (N,) float coordinate of patch element 0 inside the window.  Row i
    of the result has weight (1-f) at column floor(rel)+i and f at +i+1 —
    so S @ win (resp. win @ Sᵀ) bilinearly samples `size` consecutive
    rows (columns) at subpixel offset rel.  Replaces per-iteration patch
    gathers with small batched matmuls.

    Built as a triangle ("hat") function of the column index — one fused
    relu(1-|c - rel-i|) expression instead of two one-hot compares + blend
    (the GN chain is dispatch-latency-bound, so op count matters more than
    FLOPs here).  Leading dims of rel batch arbitrarily.
    """
    rel = jnp.clip(rel, 0.0, width - size - 1 - 1e-4)
    pos = rel[..., None, None] + jnp.arange(size, dtype=rel.dtype)[:, None]
    cols = jnp.arange(width, dtype=rel.dtype)
    return jnp.maximum(0.0, 1.0 - jnp.abs(cols - pos))


def _track_level(img_prev, grad_x, grad_y, img_next, pts_prev, flow, valid, p: LKParams):
    """One pyramid level of LK. flow is the current displacement estimate.

    The per-point search window of img_next is gathered ONCE (one block
    per point); every Gauss-Newton iteration then samples the current patch
    INSIDE that window with bilinear selection matmuls (no gathers).  The flow therefore cannot
    drift more than `search_margin` px within one level — larger motion is
    the coarser levels' job, matching pyramidal LK semantics.

    Patches that straddle a level border use edge-replicated pixels (see
    extract_patches) — degraded but directionally useful, matching OpenCV's
    border handling; points are only bounds-culled at the finest level.
    """
    r = p.radius
    m = p.search_margin
    s = 2 * r + 1
    wd = s + 2 * m + 2  # window side: patch + drift margin + bilinear tap
    n = pts_prev.shape[0]

    # Template patch + its gradients in ONE batched block gather per point.
    stacked = jnp.stack([img_prev, grad_x, grad_y])
    tgg = imops.extract_patches_multi(stacked, pts_prev, r)
    t_patch, gx, gy = tgg[:, 0], tgg[:, 1], tgg[:, 2]    # (N, S, S) each

    # 2x2 structure tensor per point (constant across iterations).
    G = jnp.stack([gx.reshape(n, -1), gy.reshape(n, -1)], axis=-1)  # (N, S², 2)
    A = jnp.einsum("nsk,nsl->nkl", G, G, precision="highest")
    a11, a12, a22 = A[:, 0, 0], A[:, 0, 1], A[:, 1, 1]
    det = a11 * a22 - a12 * a12
    tr = a11 + a22
    min_eig = (tr - jnp.sqrt(jnp.maximum(tr * tr - 4 * det, 0.0))) * 0.5
    patch_area = (2 * r + 1) ** 2
    wellcond = min_eig / patch_area > p.min_eig
    update_ok = valid & wellcond
    det_safe = jnp.where(jnp.abs(det) < 1e-12, 1.0, det)
    t_flat = t_patch.reshape(n, -1)

    # Search window around the initial position, gathered once.
    pos0 = pts_prev + flow
    corner = jnp.floor(pos0) - (r + m)
    win, corner = imops.extract_windows(img_next, corner, wd)  # (N, wd, wd)
    corner = corner.astype(flow.dtype)

    def sample(flow):
        # Patch element (0,0) sits at pos - r relative to the window corner.
        # One joint (N, 2, s, wd) selection build for both axes (fewer
        # dispatches than separate Sy/Sx), then two batched matmuls.
        rel = pts_prev + flow - corner - r
        S = _selection(rel[:, ::-1], s, wd)          # [:,0]=Sy, [:,1]=Sx
        rows = jnp.einsum("niy,nyx->nix", S[:, 0], win, precision="highest")
        return jnp.einsum("nix,njx->nij", rows, S[:, 1], precision="highest")

    # Keep the flow inside the sampled window (mirrors the clamp in sample).
    pos_lo = corner + r
    pos_hi = corner + wd - r - 2

    def clamp_flow(flow):
        pos = jnp.clip(pts_prev + flow, pos_lo, pos_hi)
        return pos - pts_prev

    flow = clamp_flow(flow)

    def gn_step(flow, converged, live):
        cur = sample(flow)
        e = cur.reshape(n, -1) - t_flat
        b = jnp.einsum("ns,nsk->nk", e, G,
                       precision="highest")              # (N, 2)
        dx = (a22 * b[:, 0] - a12 * b[:, 1]) / det_safe
        dy = (a11 * b[:, 1] - a12 * b[:, 0]) / det_safe
        delta = jnp.stack([-dx, -dy], axis=-1)
        step_ok = update_ok & ~converged & live
        flow = jnp.where(step_ok[:, None], clamp_flow(flow + delta), flow)
        converged = converged | (jnp.sum(delta * delta, axis=-1) < p.eps * p.eps)
        return flow, converged

    def body(carry):
        # Two GN iterations per while-loop trip: the loop is dispatch-latency
        # bound (each trip syncs the cond scalar), so halving the trip count
        # is nearly free FLOP-wise while keeping the early exit.
        i, flow, converged = carry
        flow, converged = gn_step(flow, converged, jnp.asarray(True))
        flow, converged = gn_step(flow, converged, i + 1 < p.iters)
        return i + 2, flow, converged

    # Early exit once (almost) every live point converged: the GN chain is
    # the frontend's dominant latency (each iteration is a handful of small
    # ops whose per-op latency, not FLOPs, sets the cost), and with IMU /
    # constant-velocity-predicted guesses most frames converge in a few
    # iterations — a while_loop makes the remaining iterations data-
    # dependent instead of always paying the worst case.  A few stragglers
    # (flat or noisy patches jittering above the eps step size) must not
    # hold the whole batch hostage: they are exactly the points the
    # downstream gates (fb check, RANSAC, MAD) discard, so the loop exits
    # when <2 % of live points are still moving.
    n_live = jnp.maximum(jnp.sum(update_ok), 1)

    def cond(carry):
        i, _, converged = carry
        unconv = jnp.sum(~converged & update_ok)
        return (i < p.iters) & (unconv * 50 > n_live)

    _, flow, _ = jax.lax.while_loop(
        cond, body, (jnp.asarray(0, jnp.int32), flow, jnp.zeros(n, bool)))
    return flow, wellcond


@functools.partial(jax.jit, static_argnames=("params", "want_err"))
def pyramidal_lk(pyrg_prev, pyr_next, pts_prev, pts_guess, valid,
                 params: LKParams = LKParams(), want_err: bool = False):
    """Track points from pyrg_prev to pyr_next.

    Args:
      pyrg_prev: gradient pyramid of the previous image — tuple of
        (img, gx, gy) per level (flvis_tpu.ops.image.build_grad_pyramid).
        Pass a plain image pyramid and gradients are computed on the fly.
      pyr_next: image pyramid of the next image — tuple of (H/2^l, W/2^l)
        arrays, or a gradient pyramid (gradients ignored).
      pts_prev: (N, 2) [x, y] point locations in the previous frame.
      pts_guess: (N, 2) initial guess for locations in the next frame
        (pass pts_prev for no prior; the frontend passes IMU-projected
        landmarks, mirroring OPTFLOW_USE_INITIAL_FLOW).
      valid: (N,) bool mask of live slots.
    Returns:
      pts_next: (N, 2) tracked locations.
      status: (N,) bool success mask (conditioning + in-bounds).
      err: (N,) mean absolute patch residual at the solution — computed only
        when `want_err` (two extra full-res patch gathers); zeros otherwise.
        No production caller consumes it (the frontend gates on RANSAC/MAD
        instead), so it defaults off rather than relying on XLA DCE through
        the jit-call boundary.
    """
    num_levels = len(pyrg_prev)
    assert len(pyr_next) == num_levels

    def level_triple(entry):
        if isinstance(entry, tuple) and len(entry) == 3:
            return entry
        return (entry,) + imops.scharr_gradients(entry)

    def level_img(entry):
        return entry[0] if isinstance(entry, tuple) else entry

    scale_top = 2.0 ** (num_levels - 1)
    flow = (pts_guess - pts_prev) / scale_top
    status = valid
    for lvl in range(num_levels - 1, -1, -1):
        s = 2.0 ** lvl
        img_p, gx, gy = level_triple(pyrg_prev[lvl])
        flow, wellcond = _track_level(
            img_p, gx, gy, level_img(pyr_next[lvl]), pts_prev / s, flow, status, params
        )
        status = status & wellcond
        if lvl > 0:
            flow = flow * 2.0

    pts_next = pts_prev + flow
    h, w = level_img(pyr_next[0]).shape
    r = params.radius
    inb = (
        (pts_next[:, 0] >= r) & (pts_next[:, 0] <= w - 1 - r)
        & (pts_next[:, 1] >= r) & (pts_next[:, 1] <= h - 1 - r)
    )
    status = status & inb
    if want_err:
        final = imops.extract_patches(level_img(pyr_next[0]), pts_next, r)
        templ = imops.extract_patches(level_img(pyrg_prev[0]), pts_prev, r)
        err = jnp.mean(jnp.abs(final - templ), axis=(1, 2))
    else:
        err = jnp.zeros(pts_next.shape[0], pts_next.dtype)
    return pts_next, status, err


@functools.partial(jax.jit, static_argnames=("params",))
def stereo_lk(pyrg_left, pyrg_right, pts_left, disparity_guess, valid,
              params: LKParams = LKParams(), fb_threshold: float = 0.7):
    """Left→right rectified-stereo track for depth recovery.

    Replaces the "inner LK" in CameraFrame::recover3DPts_c_FromStereo
    (/root/reference/src/processing/camera_frame.cpp:93-180).  The guess
    shifts along -x by disparity_guess; the vertical component of the result
    is gated (rectified epipolar lines are horizontal) and a single-level
    backward re-track from the right image must land within fb_threshold px
    of the original point — wrong depths are worse than no depths, because
    the motion BA then prefers depth-independent (rotation-only) pose fits.
    Both arguments are gradient pyramids (build_grad_pyramid).
    Returns (disparity, status).
    """
    guess = pts_left - jnp.stack([disparity_guess, jnp.zeros_like(disparity_guess)], -1)
    pts_right, status, _ = pyramidal_lk(pyrg_left, pyrg_right, pts_left, guess, valid, params)
    dy = jnp.abs(pts_right[:, 1] - pts_left[:, 1])
    disparity = pts_left[:, 0] - pts_right[:, 0]
    status = status & (dy < 1.5) & (disparity > 0.0)
    # Forward-backward consistency at full resolution only — the backward
    # start is already within a pixel or two, so one level suffices and
    # saves a full pyramid pass.
    fb_params = dataclasses.replace(params, num_levels=1, iters=max(params.iters // 2, 4))
    back, st_b, _ = pyramidal_lk(pyrg_right[:1], pyrg_left[:1], pts_right, pts_left,
                                 status, fb_params)
    fb_err = jnp.linalg.norm(back - pts_left, axis=-1)
    status = status & st_b & (fb_err < fb_threshold)
    return disparity, status
