"""Batched two-view triangulation.

Array-native replacement for the reference's Triangulation static class
(/root/reference/src/processing/triangulation.cpp:9-119), which builds a 4×4
DLT matrix from two projection matrices and takes the null vector via
JacobiSVD *per point in a loop*.  Here the whole landmark table is
triangulated at once: the 4×4 normal matrix AᵀA is formed for every point in
one batched einsum and its smallest eigenvector taken with a batched
jnp.linalg.eigh — one XLA op instead of N SVDs.

Inputs use normalized image coordinates (pixels pre-multiplied by K⁻¹), so a
projection "matrix" is just an SE3 pose.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import se3 as se3m, so3
from .se3 import SE3


def _pose_rows(T: SE3):
    """SE3 → the 3 rows of [R | t] for the DLT construction, (..., 3, 4)."""
    R = so3.to_matrix(T.q)
    return jnp.concatenate([R, T.t[..., :, None]], axis=-1)


def triangulate_dlt(T0: SE3, T1: SE3, xn0, xn1):
    """DLT triangulation of N correspondences.

    Args:
      T0, T1: camera-from-world poses (batched (..., ) or single).
      xn0, xn1: normalized coords (..., N, 2) in each view.
    Returns:
      pts_w: (..., N, 3) world points.
      cond_ok: (..., N) bool — smallest eigenvalue well-separated (non-degenerate).

    Mirrors Triangulation::triangulationPts
    (/root/reference/src/processing/triangulation.cpp:9-39) but batched.
    """
    P0 = _pose_rows(T0)  # (..., 3, 4)
    P1 = _pose_rows(T1)

    def rows(P, xn):
        # A_i rows: x * P[2] - P[0],  y * P[2] - P[1]; broadcast over N points.
        p0, p1, p2 = P[..., 0, :], P[..., 1, :], P[..., 2, :]
        x = xn[..., 0:1]
        y = xn[..., 1:2]
        r0 = x * p2[..., None, :] - p0[..., None, :]
        r1 = y * p2[..., None, :] - p1[..., None, :]
        return r0, r1

    a0, a1 = rows(P0, xn0)
    a2, a3 = rows(P1, xn1)
    A = jnp.stack([a0, a1, a2, a3], axis=-2)  # (..., N, 4, 4)
    AtA = jnp.einsum("...ij,...ik->...jk", A, A, precision="highest")
    w, V = jnp.linalg.eigh(AtA)
    h = V[..., :, 0]  # eigenvector of smallest eigenvalue
    w_h = h[..., 3]
    w_safe = jnp.where(jnp.abs(w_h) < 1e-10, 1e-10, w_h)
    pts = h[..., :3] / w_safe[..., None]
    # Degeneracy check: eigengap between the two smallest eigenvalues.
    cond_ok = (w[..., 1] - w[..., 0]) > 1e-9 * jnp.maximum(w[..., 3], 1e-12)
    return pts, cond_ok


def triangulate_from_views(T_c0_w: SE3, T_c1_w: SE3, xn0, xn1, range_max=10.0, range_min=0.1):
    """Two-pose triangulation with the reference's validity gates.

    Replaces Triangulation::trignaulationPtFromPose
    (/root/reference/src/processing/triangulation.cpp:80-97) + the range gate
    in the stereo wrapper (lines 41-54).  Returns (pts_c0, valid) where pts_c0
    is in the *first camera's* frame and valid combines cheirality + range.
    """
    pts_w, cond_ok = triangulate_dlt(T_c0_w, T_c1_w, xn0, xn1)
    pts_c0 = se3m.transform_points(T_c0_w, pts_w)
    pts_c1 = se3m.transform_points(T_c1_w, pts_w)
    z0 = pts_c0[..., 2]
    z1 = pts_c1[..., 2]
    valid = cond_ok & (z0 > range_min) & (z0 < range_max) & (z1 > 0.0)
    return pts_c0, valid


def triangulate_midpoint(T_c0_w: SE3, T_c1_w: SE3, xn0, xn1,
                         range_max=10.0, range_min=0.1):
    """Closed-form two-ray midpoint triangulation.

    Same contract as triangulate_from_views (pts in the FIRST camera's
    frame, cheirality+range validity) but solves the 2x2 closest-point
    system between the two viewing rays instead of the 4x4 DLT
    eigendecomposition — the eigh lowers to an iterative algorithm; the midpoint form is a handful of fused
    elementwise ops with equivalent accuracy for well-conditioned two-view
    geometry (degenerate near-parallel rays are gated out either way).

    Unlike triangulate_from_views, poses and rays pair 1:1 — xn* is
    (..., 2) and T_* broadcasts elementwise against its batch dims (the
    tracker passes one first-observation pose PER landmark; routing that
    through the (pose-batch × point) DLT wrapper silently outer-broadcast
    to N×N and returned every slot the depth of landmark 0).
    """
    ones = jnp.ones(xn0.shape[:-1] + (1,), xn0.dtype)
    h0 = jnp.concatenate([xn0, ones], axis=-1)          # (..., 3)
    h1 = jnp.concatenate([xn1, ones], axis=-1)
    q0c = so3.conj(T_c0_w.q)
    q1c = so3.conj(T_c1_w.q)
    C0 = -so3.rotate(q0c, T_c0_w.t)                     # (..., 3) camera centres
    C1 = -so3.rotate(q1c, T_c1_w.t)
    u0 = so3.rotate(q0c, h0)                            # (..., 3) world rays
    u1 = so3.rotate(q1c, h1)
    w = C1 - C0

    a00 = jnp.sum(u0 * u0, -1)
    a01 = jnp.sum(u0 * u1, -1)
    a11 = jnp.sum(u1 * u1, -1)
    b0 = jnp.sum(u0 * w, -1)
    b1 = jnp.sum(u1 * w, -1)
    det = a00 * a11 - a01 * a01
    det_safe = jnp.where(det < 1e-12, 1.0, det)
    a = (a11 * b0 - a01 * b1) / det_safe                # depth along ray 0
    b = (a01 * b0 - a00 * b1) / det_safe                # depth along ray 1
    P = 0.5 * (C0 + a[..., None] * u0 + C1 + b[..., None] * u1)
    pts_c0 = so3.rotate(T_c0_w.q, P) + T_c0_w.t
    z0 = pts_c0[..., 2]
    # Non-degeneracy: rays must not be parallel (sin² of the angle).
    cond_ok = det > 1e-6 * a00 * a11
    valid = cond_ok & (a > 0.0) & (b > 0.0) & (z0 > range_min) & (z0 < range_max)
    return pts_c0, valid


def stereo_rectified_depth(fx, baseline, u_left, u_right):
    """Closed-form depth for rectified stereo: z = fx·b / (uL − uR).

    The fast path replacing the per-point inner-LK + SVD in
    CameraFrame::recover3DPts_c_FromStereo
    (/root/reference/src/processing/camera_frame.cpp:93-180) once images are
    rectified; disparity must be positive for a point in front."""
    disp = u_left - u_right
    valid = disp > 0.25
    z = fx * baseline / jnp.maximum(disp, 0.25)
    return z, valid


def reprojection_error(cam_project, T_c_w: SE3, pts_w, uv_obs):
    """Pixel reprojection residual norm (Triangulation::reProjection
    equivalent, /root/reference/src/processing/triangulation.cpp:99-119)."""
    uv = cam_project(se3m.transform_points(T_c_w, pts_w))
    return jnp.linalg.norm(uv - uv_obs, axis=-1)
