"""Batched perspective-n-point: EPnP-style minimal solver + masked RANSAC.

Array-native replacement for cv::solvePnPRansac as used by the reference for
loop-closure geometric verification (P3P, 100 iters, reproj 3.0 —
/root/reference/src/backend/vo_loopclosing.cpp:670) and frame tracking
without an IMU guess (src/processing/lkorb_tracking.cpp:161-200).

P3P's closed form needs quartic root-finding (complex eigendecompositions),
which batches poorly.  Instead each minimal sample
is solved with a linear EPnP variant — 4 control points from a closed-form
Cholesky spread basis, a CGS2 null-space extraction for the control-point
camera coordinates, scale from control-point distance consistency, and a
Horn-quaternion Procrustes fit — all batched closed-form / statically-
unrolled arithmetic (no eigh/svd: those lower to iterative eigensolvers —
see ops.linalg).  All hypotheses are solved AND scored in parallel
(hypothesize-and-verify as one program, like ops.ransac).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..geometry import se3 as se3m, so3
from ..geometry.se3 import SE3
from . import linalg as la
from . import ransac as ransac_ops


def procrustes_quat(src, dst, weights=None):
    """Rigid transform (q, t) minimizing Σ w‖R(q)·src + t − dst‖² (batched).

    src, dst: (..., N, 3).  Horn's quaternion method: the optimal rotation
    is the dominant eigenvector of a symmetric 4×4 built from the weighted
    correlation — found by fixed-iteration power iteration instead of the
    Kabsch 3×3 SVD, and a proper rotation by construction (no det flip).
    """
    if weights is None:
        weights = jnp.ones(src.shape[:-1], src.dtype)
    w = weights[..., None]
    wsum = jnp.sum(w, axis=-2, keepdims=True)
    mu_s = jnp.sum(src * w, axis=-2, keepdims=True) / jnp.maximum(wsum, 1e-9)
    mu_d = jnp.sum(dst * w, axis=-2, keepdims=True) / jnp.maximum(wsum, 1e-9)
    # M[a, b] = Σ w · src_a · dst_b  (Horn's S).
    M = jnp.einsum("...na,...nb->...ab", (src - mu_s) * w, dst - mu_d,
                   precision="highest")
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = jnp.stack([
        jnp.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        jnp.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        jnp.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        jnp.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], -2)
    q = la.max_eigvec_sym(N)
    t = mu_d[..., 0, :] - so3.rotate(q, mu_s[..., 0, :])
    return q, t


def procrustes(src, dst, weights=None):
    """Rigid transform (R, t): matrix-returning wrapper of procrustes_quat."""
    q, t = procrustes_quat(src, dst, weights)
    return so3.to_matrix(q), t


def _epnp_minimal(X, xn):
    """Linear EPnP for one batch of minimal samples.

    Args:
      X: (M, K, 3) world points per hypothesis.
      xn: (M, K, 2) normalized image coords.
    Returns:
      SE3 batch (M,) of T_c_w estimates (garbage for degenerate samples —
      RANSAC scoring weeds those out).
    """
    M, K, _ = X.shape
    # Control points: centroid + a spread-matched affine basis.  The exact
    # PCA eigenbasis is unnecessary — any non-degenerate frame spanning the
    # cloud conditions the system equally well — so the closed-form
    # Cholesky factor of the covariance (L Lᵀ = cov, columns scale like the
    # principal axes) replaces the iterative eigh.
    c0 = jnp.mean(X, axis=1, keepdims=True)                     # (M, 1, 3)
    Xc = X - c0
    cov = jnp.einsum("mki,mkj->mij", Xc, Xc, precision="highest") / K
    axes = la.chol3(cov, jitter=1e-9)                            # (M, 3, 3) cols
    Cw = jnp.concatenate([c0, c0 + axes.transpose(0, 2, 1)], axis=1)  # (M, 4, 3)

    # Barycentric coordinates: X = Σ α_j C_j with Σ α = 1.
    B = (Cw[:, 1:] - Cw[:, :1]).transpose(0, 2, 1)               # (M, 3, 3)
    B_inv = la.inv3(B + 1e-9 * jnp.eye(3))
    a123 = jnp.einsum("mij,mkj->mki", B_inv, Xc,
                      precision="highest")                       # (M, K, 3)
    a0 = 1.0 - jnp.sum(a123, axis=-1, keepdims=True)
    alpha = jnp.concatenate([a0, a123], axis=-1)                 # (M, K, 4)

    # M-matrix rows: Σ_j α_j (x_j − u z_j) = 0 and (y_j − v z_j) = 0.
    u = xn[..., 0]
    v = xn[..., 1]
    zeros = jnp.zeros_like(alpha)
    row_u = jnp.stack([alpha, zeros, -u[..., None] * alpha], axis=-1)  # (M,K,4,3)
    row_v = jnp.stack([zeros, alpha, -v[..., None] * alpha], axis=-1)
    A = jnp.concatenate(
        [row_u.reshape(M, K, 12), row_v.reshape(M, K, 12)], axis=1
    )  # (M, 2K, 12); unknown layout: [c0x, c0y, c0z, c1x, ..., c3z]
    # Null vector by CGS2 row orthonormalization (ops.linalg.gs_null): at
    # most 11 rows are kept so a 1-dim null space exists exactly — for the
    # minimal K=6 sample this discards half of one correspondence's
    # information, which RANSAC hypothesis scoring absorbs (the reference's
    # P3P uses only 3 of its 4 points for the solve too).
    vvec = la.gs_null(A[:, : min(2 * K, 11)])                     # (M, 12)
    Cc = vvec.reshape(M, 4, 3)

    # Scale from control-point distance consistency; sign from cheirality.
    def pdists(C):
        d01 = C[:, 0] - C[:, 1]
        d02 = C[:, 0] - C[:, 2]
        d03 = C[:, 0] - C[:, 3]
        d12 = C[:, 1] - C[:, 2]
        d13 = C[:, 1] - C[:, 3]
        d23 = C[:, 2] - C[:, 3]
        return jnp.stack([d01, d02, d03, d12, d13, d23], axis=1)  # (M, 6, 3)

    dw = jnp.linalg.norm(pdists(Cw), axis=-1)
    dv = jnp.linalg.norm(pdists(Cc), axis=-1)
    beta = jnp.sum(dw * dv, axis=-1) / jnp.maximum(jnp.sum(dv * dv, axis=-1), 1e-12)
    Cc = Cc * beta[:, None, None]
    # Cheirality: points must be in front — flip if mean z < 0.
    zmean = jnp.einsum("mki,mk->mi", Cc, jnp.mean(alpha, axis=1),
                       precision="highest")[:, 2]
    Cc = Cc * jnp.where(zmean < 0, -1.0, 1.0)[:, None, None]

    q, t = procrustes_quat(Cw, Cc)
    return SE3(q, t)


@functools.partial(jax.jit, static_argnames=("num_hypotheses", "sample_size"))
def pnp_ransac(key, pts_w, xn, valid, threshold_n: float = 0.01,
               num_hypotheses: int = 64, sample_size: int = 6):
    """Prior-free pose from 3D-2D matches by parallel hypothesize-and-verify.

    Args:
      pts_w: (N, 3) world points.
      xn: (N, 2) NORMALIZED image coords (pixels through K⁻¹).
      valid: (N,) candidate mask.
      threshold_n: inlier reprojection threshold in normalized units
        (≈ pixels / fx; the reference uses 3 px).
    Returns (T_c_w, inliers (N,), num_inliers).
    """
    idx = ransac_ops.sample_minimal_sets(key, valid, num_hypotheses, sample_size)
    T = _epnp_minimal(pts_w[idx], xn[idx])

    # Score every hypothesis against every correspondence.
    p_c = so3.rotate(T.q[:, None, :], pts_w[None, :, :]) + T.t[:, None, :]
    z = p_c[..., 2]
    proj = p_c[..., :2] / jnp.where(jnp.abs(z[..., None]) < 1e-6, 1e-6, z[..., None])
    err = jnp.linalg.norm(proj - xn[None, :, :], axis=-1)
    inl = (err < threshold_n) & (z > 0.05) & valid[None, :]
    counts = jnp.sum(inl, axis=-1)
    best = jnp.argmax(counts)
    return se3m.index(T, best), inl[best], counts[best]
