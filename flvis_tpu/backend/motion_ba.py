"""Motion-only bundle adjustment: robust single-pose Levenberg-Marquardt.

Array-native replacement for the reference's OptimizeInFrame
(/root/reference/src/processing/optimize_in_frame.cpp:10-91): a g2o bundle of
one VertexSE3Expmap pose, fixed VertexSBAPointXYZ landmarks, and
EdgeSE3ProjectXYZ reprojection edges with a Huber kernel, run as
optimize(2) → drop chi²>3 edges → optimize(2).

Here the whole solve is closed-form batched linear algebra: analytic 2×6
Jacobians for every landmark at once, Huber IRLS weights, a 6×6 normal
system, and LM damping — one jitted program with static iteration counts.
The two-phase edge-culling schedule is reproduced with masks.

Pose parameterization: left-multiplicative retraction T ← exp(ξ)·T with
ξ = [ρ, φ] in the camera frame, so ∂p_c/∂ξ = [I | −[p_c]×].
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import se3 as se3m, so3
from ..geometry.camera import StereoCamera, project
from ..geometry.se3 import SE3


class MotionBAResult(NamedTuple):
    T_c_w: SE3
    chi2: jax.Array        # (N,) final squared pixel residuals
    inliers: jax.Array     # (N,) bool — edges that survived the chi² cull
    cost: jax.Array        # robust total cost
    num_inliers: jax.Array


def _residuals_jacobians(cam: StereoCamera, T: SE3, pts_w, uv_obs):
    """Reprojection residuals (N, 2) and Jacobians (N, 2, 6) wrt left-retraction."""
    p_c = se3m.transform_points(T, pts_w)
    uv = project(cam, p_c)
    r = uv - uv_obs
    x, y = p_c[:, 0], p_c[:, 1]
    z = jnp.where(jnp.abs(p_c[:, 2]) < 1e-6, 1e-6, p_c[:, 2])
    iz = 1.0 / z
    iz2 = iz * iz
    fx, fy = cam.fx, cam.fy
    # d(uv)/d(p_c): (N, 2, 3)
    duv = jnp.stack(
        [
            jnp.stack([fx * iz, jnp.zeros_like(iz), -fx * x * iz2], -1),
            jnp.stack([jnp.zeros_like(iz), fy * iz, -fy * y * iz2], -1),
        ],
        axis=1,
    )
    # d(p_c)/d(xi) = [I | -hat(p_c)]: (N, 3, 6)
    I = jnp.broadcast_to(jnp.eye(3), p_c.shape[:-1] + (3, 3))
    dp = jnp.concatenate([I, -so3.hat(p_c)], axis=-1)
    J = jnp.matmul(duv, dp, precision="highest")  # (N, 2, 6)
    behind = p_c[:, 2] <= 0.05
    return r, J, behind


def _huber_weight(r2, delta):
    """IRLS weight for the Huber kernel on squared residual norm r2."""
    r = jnp.sqrt(jnp.maximum(r2, 1e-12))
    return jnp.where(r <= delta, 1.0, delta / r)


def _qr_solve6(A, b):
    """Least-squares solve of a tall (M, 6) system via unrolled CGS2 QR.

    jnp.linalg.lstsq lowers to an iterative SVD — far too slow for a
    6-column system inside the per-frame loop.  Classical Gram-Schmidt with
    one reorthogonalization pass is 6 statically-unrolled column steps of
    dot products, and its loss of orthogonality is O(eps·cond(A)),
    equivalent to Householder for the conditioning this solver faces
    (cond(J) ≲ 1e3 by design — see the damping note below)."""
    q_cols = []
    r_rows = []
    for j in range(6):
        v = A[:, j]
        rj = jnp.zeros((6,), A.dtype)
        for _ in range(2):  # CGS2: second pass removes f32 projection residue
            for i, qi in enumerate(q_cols):
                c = jnp.dot(qi, v, precision="highest")
                rj = rj.at[i].add(c)
                v = v - c * qi
        nrm = jnp.sqrt(jnp.maximum(jnp.dot(v, v, precision="highest"), 1e-20))
        rj = rj.at[j].set(nrm)
        q_cols.append(v / nrm)
        r_rows.append(rj)
    Q = jnp.stack(q_cols, axis=1)                      # (M, 6)
    R = jnp.stack(r_rows, axis=1)                      # (6, 6) upper-triangular
    # (r_rows[j] holds column j's projections onto q_0..q_j, i.e. R[:, j].)
    y = jnp.matmul(Q.T, b, precision="highest")
    # Back-substitution, unrolled.
    x = jnp.zeros((6,), A.dtype)
    for j in range(5, -1, -1):
        x = x.at[j].set((y[j] - jnp.dot(R[j], x, precision="highest"))
                        / R[j, j])
    return x


def _lm_iterations(cam, T, pts_w, uv_obs, active, iters: int, huber_delta, lam0):
    def cost_of(T):
        p_c = se3m.transform_points(T, pts_w)
        r = project(cam, p_c) - uv_obs
        r2 = jnp.sum(r * r, axis=-1)
        w = _huber_weight(r2, huber_delta)
        rho = jnp.where(
            jnp.sqrt(jnp.maximum(r2, 1e-12)) <= huber_delta,
            0.5 * r2,
            huber_delta * (jnp.sqrt(jnp.maximum(r2, 1e-12)) - 0.5 * huber_delta),
        )
        return jnp.sum(jnp.where(active & (p_c[:, 2] > 0.05), rho, 0.0)), w

    def body(_, carry):
        T, lam, cost = carry
        r, J, behind = _residuals_jacobians(cam, T, pts_w, uv_obs)
        use = active & ~behind
        r2 = jnp.sum(r * r, axis=-1)
        w = _huber_weight(r2, huber_delta) * use.astype(r.dtype)
        # Damped least squares solved directly on the Jacobian (QR/SVD), NOT
        # via the normal equations: uniform-depth scenes make the t_x/ω_y
        # (and t_y/ω_x) directions nearly parallel, cond(H) = cond(J)² can
        # reach ~1e6, and an f32 normal-equation solve then corrupts the GN
        # step badly enough that LM settles into a rotation-only basin with
        # 3× the residual of the true pose.  The solver runs in f32;
        # factoring J keeps the conditioning at cond(J) ≈ 1e3, well within
        # f32.
        sw = jnp.sqrt(w)[:, None]
        Jw = (J * sw[..., None]).reshape(-1, 6)
        rw = (r * sw).reshape(-1)
        col = jnp.sqrt(lam * jnp.sum(Jw * Jw, axis=0) + 1e-12)
        A = jnp.concatenate([Jw, jnp.diag(col)], axis=0)
        rhs = jnp.concatenate([-rw, jnp.zeros(6, rw.dtype)])
        dx = _qr_solve6(A, rhs)
        T_new = se3m.retract_left(T, dx)
        new_cost, _ = cost_of(T_new)
        better = new_cost < cost
        T = jax.tree.map(lambda a, b: jnp.where(better, b, a), T, T_new)
        lam = jnp.where(better, jnp.maximum(lam * 0.5, 1e-7), jnp.minimum(lam * 4.0, 1e4))
        cost = jnp.where(better, new_cost, cost)
        return T, lam, cost

    cost0, _ = cost_of(T)
    T, lam, cost = jax.lax.fori_loop(0, iters, body, (T, lam0, cost0))
    return T, cost


@functools.partial(jax.jit, static_argnames=("iters1", "iters2"))
def optimize_pose(cam: StereoCamera, T_init: SE3, pts_w, uv_obs, valid,
                  iters1: int = 3, iters2: int = 5, huber_delta: float = 2.0,
                  chi2_cull: float = 9.0, min_points: int = 10) -> MotionBAResult:
    """Robust motion-only BA.

    Args:
      cam: rectified camera model.
      T_init: initial T_c_w (from LK+prior tracking).
      pts_w: (N, 3) fixed landmark world positions.
      uv_obs: (N, 2) observed pixels in the current frame.
      valid: (N,) mask of usable observations.
    Two-phase schedule mirroring the reference: a first LM pass, a chi² cull
    (the reference drops edges with chi² > 3 after optimize(2),
    optimize_in_frame.cpp:64-80), and a second LM pass on survivors.  If
    fewer than min_points observations remain the input pose is returned
    unchanged (the reference bails out below 10 edges).
    """
    n_valid = jnp.sum(valid)
    T1, _ = _lm_iterations(cam, T_init, pts_w, uv_obs, valid, iters1, huber_delta, 1e-3)

    r, _, behind = _residuals_jacobians(cam, T1, pts_w, uv_obs)
    chi2 = jnp.sum(r * r, axis=-1)
    # Adaptive cull: the absolute chi² gate (≈3 px) misses landmarks whose
    # stale/wrong depths induce sub-pixel-but-systematic residuals, and in a
    # near-uniform-depth scene those few points drag the quadratic cost
    # toward a depth-independent rotation-only pose.  Cut at 9× the median
    # chi² (≡ 3× the median residual), floored so clean tight fits don't
    # self-cannibalise, capped by the absolute gate.
    med = jnp.nanmedian(jnp.where(valid & ~behind, chi2, jnp.nan))
    adaptive = jnp.minimum(jnp.maximum(9.0 * jnp.nan_to_num(med, nan=chi2_cull),
                                       0.25), chi2_cull)
    keep = valid & ~behind & (chi2 < adaptive)

    T2, cost = _lm_iterations(cam, T1, pts_w, uv_obs, keep, iters2, huber_delta, 1e-4)

    r2, _, behind2 = _residuals_jacobians(cam, T2, pts_w, uv_obs)
    chi2_final = jnp.sum(r2 * r2, axis=-1)
    inliers = keep & ~behind2 & (chi2_final < chi2_cull)

    enough = (n_valid >= min_points) & (jnp.sum(keep) >= min_points)
    T_out = jax.tree.map(lambda a, b: jnp.where(enough, b, a), T_init, T2)
    # On bail-out, report the chi²-gated survivors (NOT the raw valid mask) so
    # callers correctly see inlier starvation — the reference's failure signal
    # (<10 inliers at any stage, lkorb_tracking.cpp:121,155,192).
    inliers = jnp.where(enough, inliers, keep)
    return MotionBAResult(T_out, chi2_final, inliers, cost, jnp.sum(inliers))
