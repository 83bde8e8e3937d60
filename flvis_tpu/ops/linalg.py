"""Closed-form / fixed-iteration small linear algebra.

jnp.linalg's eigh/svd/lstsq/inv lower to iterative algorithms (QR sweeps,
Jacobi rotations, blocked LU) run as library calls per batch; for the tiny
fixed-size systems SLAM needs (3×3 covariances, 12-column minimal systems,
4×4 quaternion forms) closed-form expressions or statically unrolled
orthogonalization are elementwise work that fuses into a handful of
kernels.  Every routine here is batched over leading dims and
contains no data-dependent control flow.

Replaces the dense-solver roles g2o/OpenCV play in the reference
(/root/reference/src/backend/vo_loopclosing.cpp:670 solvePnPRansac,
src/processing/optimize_in_frame.cpp:10-91).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def inv3(B):
    """Closed-form inverse of general (..., 3, 3) matrices (adjugate/det)."""
    a, b, c = B[..., 0, 0], B[..., 0, 1], B[..., 0, 2]
    d, e, f = B[..., 1, 0], B[..., 1, 1], B[..., 1, 2]
    g, h, i = B[..., 2, 0], B[..., 2, 1], B[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    idet = jnp.where(jnp.abs(det) > 1e-20, 1.0 / det, 0.0)[..., None, None]
    adj = jnp.stack([
        jnp.stack([A00, A01, A02], -1),
        jnp.stack([A10, A11, A12], -1),
        jnp.stack([A20, A21, A22], -1),
    ], -2)
    return adj * idet


def chol3(S, jitter: float = 1e-9):
    """Closed-form Cholesky factor of symmetric PSD (..., 3, 3) matrices.

    Returns lower-triangular L with S ≈ L Lᵀ.  Used e.g. as a spread-
    matched affine basis of a point cloud (EPnP control points) where an
    exact eigenbasis is unnecessary."""
    a = jnp.maximum(S[..., 0, 0], jitter)
    l00 = jnp.sqrt(a)
    l10 = S[..., 1, 0] / l00
    l20 = S[..., 2, 0] / l00
    d1 = jnp.maximum(S[..., 1, 1] - l10 * l10, jitter)
    l11 = jnp.sqrt(d1)
    l21 = (S[..., 2, 1] - l20 * l10) / l11
    d2 = jnp.maximum(S[..., 2, 2] - l20 * l20 - l21 * l21, jitter)
    l22 = jnp.sqrt(d2)
    z = jnp.zeros_like(l00)
    return jnp.stack([
        jnp.stack([l00, z, z], -1),
        jnp.stack([l10, l11, z], -1),
        jnp.stack([l20, l21, l22], -1),
    ], -2)


def gs_null(A):
    """Unit vector most orthogonal to the rows of A (..., R, C), R < C.

    Statically-unrolled CGS2 orthonormalization of the R rows, then the
    best-conditioned residual column of I − QᵀQ — exact null-space
    extraction from batched dots/matmuls (jnp.linalg.eigh/svd of AᵀA lower
    to iterative eigensolvers).  Rows that become numerically
    dependent are dropped (their q is zeroed), so rank-deficient batches
    return a vector from the larger null space instead of noise."""
    R, C = A.shape[-2], A.shape[-1]
    qs = []
    for j in range(R):
        v = A[..., j, :]
        for _ in range(2):  # CGS2: second pass removes f32 projection residue
            for qi in qs:
                v = v - jnp.sum(qi * v, -1, keepdims=True) * qi
        n2 = jnp.sum(v * v, -1, keepdims=True)
        v = jnp.where(n2 > 1e-16, v / jnp.sqrt(jnp.maximum(n2, 1e-20)), 0.0)
        qs.append(v)
    Q = jnp.stack(qs, axis=-2)                                  # (..., R, C)
    P = jnp.eye(C) - jnp.einsum("...kj,...kl->...jl", Q, Q,
                                precision="highest")
    diag = jnp.diagonal(P, axis1=-2, axis2=-1)
    pick = jax.nn.one_hot(jnp.argmax(diag, axis=-1), C, dtype=P.dtype)
    h = jnp.einsum("...jl,...l->...j", P, pick, precision="highest")
    return h / jnp.linalg.norm(h, axis=-1, keepdims=True).clip(1e-12)


def sym3_inv(H):
    """Closed-form inverse of symmetric (..., 3, 3) blocks."""
    a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e, f = H[..., 1, 1], H[..., 1, 2], H[..., 2, 2]
    A00 = d * f - e * e
    A01 = c * e - b * f
    A02 = b * e - c * d
    A11 = a * f - c * c
    A12 = b * c - a * e
    A22 = a * d - b * b
    det = a * A00 + b * A01 + c * A02
    idet = jnp.where(jnp.abs(det) > 1e-30, 1.0 / det, 0.0)[..., None, None]
    adj = jnp.stack([
        jnp.stack([A00, A01, A02], -1),
        jnp.stack([A01, A11, A12], -1),
        jnp.stack([A02, A12, A22], -1),
    ], -2)
    return adj * idet


def max_eigvec_sym(K, squarings: int = 5, iters: int = 3):
    """Dominant (algebraically largest) eigenvector of symmetric (..., D, D),
    batched, fixed op count.

    Plain shifted power iteration converges at ratio (λ₂+σ)/(λ₁+σ), which a
    safe shift σ ≈ ‖K‖_F pushes arbitrarily close to 1.  Instead the shifted
    matrix is repeatedly SQUARED (with renormalization): s squarings raise
    the spectrum to the 2^s power, so the final matvecs converge like
    (λ₂/λ₁)^(2^s · iters) — 5 squarings + 3 matvecs ≈ a 96-step power
    iteration for the cost of 8 batched matmuls."""
    D = K.shape[-1]
    shift = jnp.sqrt(jnp.sum(K * K, axis=(-2, -1), keepdims=True)) + 1e-6
    M = K + shift * jnp.eye(D)
    M = M / shift  # keep entries O(1) under squaring
    for _ in range(squarings):
        M = jnp.einsum("...ij,...jk->...ik", M, M, precision="highest")
        M = M / jnp.sqrt(jnp.sum(M * M, axis=(-2, -1), keepdims=True)).clip(1e-30)
    v = jnp.full(K.shape[:-1], 1.0 / jnp.sqrt(D), K.dtype)
    # Deterministic symmetry breaking (power iteration stalls on exact
    # symmetry planes of the start vector).
    v = v + 1e-3 * jnp.arange(D, dtype=K.dtype)
    for _ in range(iters):
        v = jnp.einsum("...ij,...j->...i", M, v, precision="highest")
        v = v / jnp.linalg.norm(v, axis=-1, keepdims=True).clip(1e-20)
    return v
