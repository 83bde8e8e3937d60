"""Batched SE(3) rigid transforms as (quaternion, translation) array pairs.

Array-native replacement for the vendored Sophus SE3 class
(/root/reference/3rdPartLib/Sophus/sophus/se3.h) which the reference uses as
its universal pose type (`T_c_w`, `T_c_c1`, ... — see
/root/reference/src/utils/include/common.h:18-27).

Representation: a plain pytree dataclass `SE3(q, t)` with q: (..., 4)
Hamilton wxyz unit quaternion and t: (..., 3).  Transform action is
x_out = R(q) x + t.  Everything broadcasts over leading batch dims and is
jit/vmap/grad-safe.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from . import so3

_EPS = 1e-8


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SE3:
    q: jax.Array  # (..., 4) unit quaternion wxyz
    t: jax.Array  # (..., 3)

    @property
    def batch_shape(self):
        return self.t.shape[:-1]

    def __matmul__(self, other: "SE3") -> "SE3":
        return compose(self, other)


def identity(batch_shape=(), dtype=jnp.float32) -> SE3:
    return SE3(so3.identity(batch_shape, dtype), jnp.zeros(batch_shape + (3,), dtype))


def from_matrix(T) -> SE3:
    """(..., 4, 4) homogeneous matrices → SE3."""
    return SE3(so3.from_matrix(T[..., :3, :3]), T[..., :3, 3])


def from_Rt(R, t) -> SE3:
    return SE3(so3.from_matrix(R), jnp.asarray(t))


def to_matrix(T: SE3):
    R = so3.to_matrix(T.q)
    top = jnp.concatenate([R, T.t[..., :, None]], axis=-1)
    bottom = jnp.zeros_like(top[..., :1, :]).at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def compose(a: SE3, b: SE3) -> SE3:
    """a ∘ b: apply b first, then a."""
    return SE3(so3.normalize(so3.mul(a.q, b.q)), so3.rotate(a.q, b.t) + a.t)


def inverse(T: SE3) -> SE3:
    qi = so3.conj(T.q)
    return SE3(qi, -so3.rotate(qi, T.t))


def apply(T: SE3, pts):
    """Transform points (..., 3); T broadcasts against pts' batch dims."""
    return so3.rotate(T.q[..., None, :] if T.q.ndim == pts.ndim else T.q, pts) + (
        T.t[..., None, :] if T.t.ndim == pts.ndim else T.t
    )


def transform_points(T: SE3, pts):
    """Transform a point cloud pts (N, 3) by a single SE3 (or batched 1:1)."""
    return so3.rotate(T.q, pts) + T.t


def exp(xi) -> SE3:
    """se(3) twist (..., 6) [rho, phi] → SE3 via the exponential map."""
    rho, phi = xi[..., :3], xi[..., 3:]
    q = so3.exp(phi)
    theta2 = jnp.sum(phi * phi, axis=-1, keepdims=True)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    # V = I + (1-cosθ)/θ² [φ]× + (θ-sinθ)/θ³ [φ]×²
    a = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    b = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (theta2 * theta))
    cr = jnp.cross(phi, rho)
    t = rho + a * cr + b * jnp.cross(phi, cr)
    return SE3(q, t)


def log(T: SE3):
    """SE3 → twist (..., 6) [rho, phi]."""
    phi = so3.log(T.q)
    theta2 = jnp.sum(phi * phi, axis=-1, keepdims=True)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    half = 0.5 * theta
    # V⁻¹ = I - ½[φ]× + (1/θ² - cot(θ/2)/(2θ)) [φ]×²
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * jnp.cos(half) / jnp.maximum(jnp.sin(half), _EPS)) / jnp.maximum(theta2, _EPS * _EPS),
    )
    cr = jnp.cross(phi, T.t)
    rho = T.t - 0.5 * cr + cot_term * jnp.cross(phi, cr)
    return jnp.concatenate([rho, phi], axis=-1)


def retract(T: SE3, xi) -> SE3:
    """Right-multiplicative retraction T ∘ exp(xi) used by the LM optimizers."""
    return compose(T, exp(xi))


def retract_left(T: SE3, xi) -> SE3:
    """Left-multiplicative retraction exp(xi) ∘ T (g2o SE3Expmap oplus style,
    cf. the pose update convention in /root/reference's g2o
    VertexSE3Expmap usage, src/processing/optimize_in_frame.cpp:26-86)."""
    return compose(exp(xi), T)


def distance(a: SE3, b: SE3):
    """(translation L2, rotation angle) between two poses — the keyframe
    decision metric (t-norm ≥ 0.05 m or r-norm ≥ 0.2 rad,
    /root/reference/src/frontend/f2f_tracking.cpp:338-354)."""
    rel = compose(inverse(a), b)
    return jnp.linalg.norm(rel.t, axis=-1), jnp.linalg.norm(so3.log(rel.q), axis=-1)


def stack(transforms):
    return SE3(
        jnp.stack([T.q for T in transforms], axis=0),
        jnp.stack([T.t for T in transforms], axis=0),
    )


def index(T: SE3, i) -> SE3:
    return SE3(T.q[i], T.t[i])
