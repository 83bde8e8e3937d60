"""Batched SO(3) on unit quaternions.

Array-native replacement for the vendored Sophus SO3 type used throughout the
reference (cf. /root/reference/src/utils/include/common.h:18-27 and
3rdPartLib/Sophus/sophus/so3.h).  Instead of a C++ class holding a single
rotation, every function here is a pure JAX function broadcasting over
arbitrary leading batch dimensions, so a whole landmark table / keyframe
window is rotated in one fused XLA op.

Conventions:
  - Hamilton quaternions, components ordered (w, x, y, z), shape (..., 4).
  - Unit quaternions represent active rotations: R(q) v = q ⊗ v ⊗ q⁻¹.
  - exp/log use the rotation-vector (axis-angle) chart, shape (..., 3).

All trig near the identity is guarded with Taylor expansions selected by
jnp.where so the functions are safe under jit/grad at theta → 0.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-8


def identity(batch_shape=(), dtype=jnp.float32):
    q = jnp.zeros(batch_shape + (4,), dtype)
    return q.at[..., 0].set(1.0)


def normalize(q):
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def mul(a, b):
    """Hamilton product a ⊗ b, batched."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def conj(q):
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], q.dtype)


inverse = conj  # unit quaternions


def rotate(q, v):
    """Rotate vectors v (..., 3) by quaternions q (..., 4).

    Uses the expanded 2-cross-product form (no matrix materialisation):
      v' = v + 2 w (u × v) + 2 u × (u × v),  u = q.xyz
    """
    u = q[..., 1:]
    w = q[..., :1]
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def to_matrix(q):
    """(..., 4) → (..., 3, 3) rotation matrices."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def from_matrix(R):
    """(..., 3, 3) → (..., 4) via Shepperd's branch-free-ised method.

    Computes all four candidate quaternions and selects the numerically best
    (largest pivot) with jnp.where — no data-dependent control flow, so it
    batches and jits cleanly.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidates, each scaled by 4*component² (always ≥ 0).
    qw = jnp.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = jnp.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], axis=-1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], axis=-1)

    pivots = jnp.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        axis=-1,
    )
    best = jnp.argmax(pivots, axis=-1)[..., None, None]
    cand = jnp.stack([qw, qx, qy, qz], axis=-2)  # (..., 4 candidates, 4)
    q = jnp.take_along_axis(cand, jnp.broadcast_to(best, cand.shape[:-2] + (1, 4)), axis=-2)
    q = q[..., 0, :]
    q = normalize(q)
    # Canonicalise sign: w ≥ 0.
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def exp(phi):
    """Rotation vector (..., 3) → quaternion (..., 4)."""
    theta2 = jnp.sum(phi * phi, axis=-1, keepdims=True)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    half = 0.5 * theta
    small = theta2 < _EPS
    # sin(θ/2)/θ with Taylor fallback 1/2 - θ²/48.
    k = jnp.where(small, 0.5 - theta2 / 48.0, jnp.sin(half) / theta)
    w = jnp.where(small, 1.0 - theta2 / 8.0, jnp.cos(half))
    return jnp.concatenate([w, k * phi], axis=-1)


def log(q):
    """Quaternion (..., 4) → rotation vector (..., 3).

    Mirrors Sophus' SO3::log used for the keyframe-decision rotation norm
    (/root/reference/src/frontend/f2f_tracking.cpp:338-354).
    """
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)  # take the short way around
    w = jnp.clip(q[..., :1], -1.0, 1.0)
    n = jnp.linalg.norm(q[..., 1:], axis=-1, keepdims=True)
    small = n < _EPS
    n_safe = jnp.where(small, 1.0, n)
    theta = 2.0 * jnp.arctan2(n, w)
    k = jnp.where(small, 2.0 / jnp.maximum(w, 0.5), theta / n_safe)
    return k * q[..., 1:]


def hat(phi):
    """(..., 3) → (..., 3, 3) skew matrices (kinetic_math.h skew equivalent)."""
    z = jnp.zeros_like(phi[..., 0])
    x, y, w = phi[..., 0], phi[..., 1], phi[..., 2]
    m = jnp.stack([z, -w, y, w, z, -x, -y, x, z], axis=-1)
    return m.reshape(phi.shape[:-1] + (3, 3))


def slerp(q0, q1, t):
    """Spherical interpolation, used for IMU roll/pitch blending."""
    d = jnp.sum(q0 * q1, axis=-1, keepdims=True)
    q1 = jnp.where(d < 0, -q1, q1)
    d = jnp.abs(d)
    # For nearly-parallel quaternions fall back to lerp.
    theta = jnp.arccos(jnp.clip(d, -1.0, 1.0))
    sin_t = jnp.sin(theta)
    near = sin_t < 1e-5
    w0 = jnp.where(near, 1.0 - t, jnp.sin((1.0 - t) * theta) / jnp.where(near, 1.0, sin_t))
    w1 = jnp.where(near, t, jnp.sin(t * theta) / jnp.where(near, 1.0, sin_t))
    return normalize(w0 * q0 + w1 * q1)


def from_euler_zyx(rpy):
    """roll/pitch/yaw (..., 3) → quaternion, ZYX convention.

    Matches the reference's rpy2Q (/root/reference/src/utils/include/
    kinetic_math.h:17-141, ZYX convention noted at lines 9-12).
    """
    r, p, y = rpy[..., 0] * 0.5, rpy[..., 1] * 0.5, rpy[..., 2] * 0.5
    cr, sr = jnp.cos(r), jnp.sin(r)
    cp, sp = jnp.cos(p), jnp.sin(p)
    cy, sy = jnp.cos(y), jnp.sin(y)
    return jnp.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        axis=-1,
    )


def to_euler_zyx(q):
    """Quaternion → roll/pitch/yaw (ZYX), inverse of from_euler_zyx."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = jnp.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = jnp.arcsin(jnp.clip(2 * (w * y - z * x), -1.0, 1.0))
    yaw = jnp.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return jnp.stack([roll, pitch, yaw], axis=-1)
