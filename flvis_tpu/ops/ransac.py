"""RANSAC as masked batched hypothesis scoring.

The reference calls cv::findFundamentalMat(FM_RANSAC) as a consistency gate
after LK tracking (/root/reference/src/processing/lkorb_tracking.cpp:132-158)
and cv::solvePnPRansac for pose (lines 161-200) — sequential hypothesize-and-
verify loops with data-dependent termination.  Here RANSAC is re-cast as a
fixed grid of hypotheses evaluated in parallel: sample all minimal sets at
once (masked sampling via random-score top-k so only valid correspondences
are drawn), solve every minimal problem as one batched linear-algebra op, and
score every hypothesis against every correspondence as one (M, N) matrix of
residuals.  argmax inlier count picks the model.  No early exit — the whole
thing is a single static XLA program.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def sample_minimal_sets(key, valid, num_hypotheses: int, sample_size: int):
    """(M, k) indices of random valid points per hypothesis.

    Masked sampling trick: draw iid uniforms per (hypothesis, point), add -inf
    to invalid slots, take top-k → k distinct uniformly-random valid indices.
    """
    n = valid.shape[0]
    scores = jax.random.uniform(key, (num_hypotheses, n))
    scores = jnp.where(valid[None, :], scores, -jnp.inf)
    _, idx = jax.lax.top_k(scores, sample_size)
    return idx


def _hartley_normalize(pts, valid):
    """Similarity transform sending valid points to zero-mean, RMS √2."""
    w = valid.astype(pts.dtype)
    n = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(pts * w[:, None], axis=0) / n
    d = jnp.linalg.norm(pts - mean, axis=-1)
    scale = jnp.sqrt(2.0) / jnp.maximum(jnp.sum(d * w) / n, 1e-8)
    T = jnp.asarray(
        [[1.0, 0.0, -mean[0]], [0.0, 1.0, -mean[1]], [0.0, 0.0, 1.0 / scale]]
    ) * scale
    T = T.at[2, 2].set(1.0)
    return (pts - mean) * scale, T


def _null9(A):
    """Unit null vector of each (8, 9) minimal system, batched: (M, 8, 9) →
    (M, 9) — CGS2 null-space extraction (ops.linalg.gs_null), replacing a
    batched 9×9 jnp.linalg.eigh that lowers to an iterative eigensolver."""
    from . import linalg as la

    return la.gs_null(A)


def _rank2_project(F):
    """Nearest rank-2 matrix: F(I − v₃v₃ᵀ) with v₃ the smallest right
    singular vector, found by shifted power iteration on FᵀF — replaces a
    batched 3×3 SVD (an iterative lowering)."""
    G = jnp.einsum("mji,mjk->mik", F, F, precision="highest")   # FᵀF, (M,3,3)
    sigma = jnp.trace(G, axis1=-2, axis2=-1)[:, None, None]
    B = sigma * jnp.eye(3) - G
    v = jnp.full((F.shape[0], 3), 1.0 / jnp.sqrt(3.0), F.dtype)
    v = v.at[:, 1].add(1e-3).at[:, 2].add(-2e-3)  # break symmetry
    for _ in range(12):
        v = jnp.einsum("mij,mj->mi", B, v, precision="highest")
        v = v / jnp.linalg.norm(v, axis=-1, keepdims=True).clip(1e-20)
    return F - jnp.einsum("mij,mj,mk->mik", F, v, v, precision="highest")


def _eight_point(p0, p1):
    """Batched 8-point fundamental matrix. p0, p1: (M, 8, 2) → F: (M, 3, 3)."""
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    ones = jnp.ones_like(x0)
    # Row for x1ᵀ F x0 = 0.
    A = jnp.stack(
        [x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0, ones], axis=-1
    )  # (M, 8, 9)
    F = _null9(A).reshape(-1, 3, 3)
    return _rank2_project(F)


def sampson_distance(F, p0, p1):
    """Squared Sampson distance. F: (M,3,3), p0/p1: (N,2) → (M,N)."""
    x0 = jnp.concatenate([p0, jnp.ones_like(p0[:, :1])], axis=-1)  # (N,3)
    x1 = jnp.concatenate([p1, jnp.ones_like(p1[:, :1])], axis=-1)
    hp = dict(precision="highest")
    Fx0 = jnp.einsum("mij,nj->mni", F, x0, **hp)     # (M,N,3)
    Ftx1 = jnp.einsum("mji,nj->mni", F, x1, **hp)
    num = jnp.einsum("ni,mni->mn", x1, Fx0, **hp) ** 2
    den = Fx0[..., 0] ** 2 + Fx0[..., 1] ** 2 + Ftx1[..., 0] ** 2 + Ftx1[..., 1] ** 2
    return num / jnp.maximum(den, 1e-12)


@functools.partial(jax.jit, static_argnames=("num_hypotheses",))
def fundamental_ransac(key, pts0, pts1, valid, threshold=3.0, num_hypotheses=128):
    """Fundamental-matrix RANSAC gate.

    Args:
      pts0, pts1: (N, 2) pixel correspondences (prev, cur).
      valid: (N,) candidate mask.
      threshold: inlier Sampson distance in pixels (the reference passes 3.0
        via cv::findFundamentalMat in lkorb_tracking.cpp:134).
    Returns:
      inliers: (N,) bool mask (subset of valid).
      best_F: (3, 3) in *pixel* coordinates.
      num_inliers: scalar int.
    """
    n0, T0 = _hartley_normalize(pts0, valid)
    n1, T1 = _hartley_normalize(pts1, valid)

    idx = sample_minimal_sets(key, valid, num_hypotheses, 8)
    F = _eight_point(n0[idx], n1[idx])

    d2 = sampson_distance(F, n0, n1)
    # Threshold must be normalized the same way as the points; use the mean of
    # the two scales.
    s = 0.5 * (T0[0, 0] + T1[0, 0])
    t2 = (threshold * s) ** 2
    inl = (d2 < t2) & valid[None, :]
    counts = jnp.sum(inl, axis=-1)
    best = jnp.argmax(counts)
    inliers = inl[best]
    # Denormalize: F_px = T1ᵀ F T0.
    best_F = jnp.matmul(jnp.matmul(T1.T, F[best], precision="highest"), T0,
                        precision="highest")
    return inliers, best_F, counts[best]


@functools.partial(jax.jit, static_argnames=())
def mad_gate(residuals, valid, sigma_mult=3.0, min_threshold=1.5):
    """Median-absolute-deviation outlier gate on reprojection error norms.

    Replaces CameraFrame::calReprjInlierOutlier's median + MAD threshold
    (/root/reference/src/processing/camera_frame.cpp:43-91): points whose
    residual exceeds max(min_threshold, median + sigma_mult * 1.4826 * MAD)
    are outliers.  Masked median via sorting with +inf padding.
    """
    big = jnp.where(valid, residuals, jnp.inf)
    n = jnp.maximum(jnp.sum(valid), 1)
    srt = jnp.sort(big)
    med = srt[(n - 1) // 2]
    mad = jnp.sort(jnp.where(valid, jnp.abs(residuals - med), jnp.inf))[(n - 1) // 2]
    thr = jnp.maximum(min_threshold, med + sigma_mult * 1.4826 * mad)
    return valid & (residuals < thr), thr
