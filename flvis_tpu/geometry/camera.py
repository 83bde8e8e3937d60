"""Pinhole / rectified-stereo camera model.

Array-native replacement for the reference's DepthCamera
(/root/reference/src/processing/depth_camera.cpp:6-149,
include/depth_camera.h:15-76) which holds raw+rectified intrinsics,
distortion, rectification matrices, the stereo extrinsic T_cam0_cam1 and the
depth scale factor, plus static world↔camera↔pixel projection helpers.

Design difference (deliberate): distortion removal and stereo
rectification are *host-side preprocessing* done once per image by the
dataset drivers (flvis_tpu.io.rectify) — the device-side model is always an
ideal rectified pinhole pair.  That keeps every on-device projection a pure
fused multiply-add over batched landmark arrays, with no per-point iterative
undistortion inside the hot loop.  This mirrors how the reference handles
STEREO_UNRECT: it calls cv::stereoRectify once in onInit
(/root/reference/src/frontend/vo_tracking.cpp:174-264) and cv::undistortPoints
per frame; we fold both into the ingest stage.

All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from . import se3 as se3m
from .se3 import SE3


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StereoCamera:
    """Rectified stereo pinhole pair (also covers RGB-D via depth_factor).

    fx, fy, cx, cy: rectified intrinsics of cam0 (left).  The right camera
    shares them (ideal rectification) and sits at baseline b along +x, i.e.
    T_c1_c0 = (I, [-b, 0, 0]) so u_right = u_left - fx*b/z.
    """

    fx: jax.Array
    fy: jax.Array
    cx: jax.Array
    cy: jax.Array
    baseline: jax.Array  # metres; 0 for pure RGB-D
    depth_factor: jax.Array  # raw depth units → metres divisor (D435: 1000)
    width: int = dataclasses.field(metadata=dict(static=True), default=640)
    height: int = dataclasses.field(metadata=dict(static=True), default=480)

    @property
    def K(self):
        z = jnp.zeros_like(self.fx)
        o = jnp.ones_like(self.fx)
        return jnp.stack(
            [
                jnp.stack([self.fx, z, self.cx], -1),
                jnp.stack([z, self.fy, self.cy], -1),
                jnp.stack([z, z, o], -1),
            ],
            axis=-2,
        )


def make(fx, fy, cx, cy, baseline=0.0, depth_factor=1000.0, width=640, height=480,
         dtype=jnp.float32) -> StereoCamera:
    f = lambda v: jnp.asarray(v, dtype)
    return StereoCamera(f(fx), f(fy), f(cx), f(cy), f(baseline), f(depth_factor),
                        int(width), int(height))


def project(cam: StereoCamera, pts_c):
    """Camera-frame points (..., 3) → pixel coords (..., 2) in cam0.

    Equivalent of DepthCamera::camera2pixel
    (/root/reference/src/processing/depth_camera.cpp:92-149).
    """
    z = pts_c[..., 2:3]
    z_safe = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    uv = pts_c[..., :2] / z_safe
    return jnp.stack(
        [cam.fx * uv[..., 0] + cam.cx, cam.fy * uv[..., 1] + cam.cy], axis=-1
    )


def project_stereo(cam: StereoCamera, pts_c):
    """→ (u_left, v, u_right) (..., 3) for stereo reprojection residuals."""
    z = pts_c[..., 2:3]
    z_safe = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    x, y = pts_c[..., 0], pts_c[..., 1]
    zs = z_safe[..., 0]
    ul = cam.fx * x / zs + cam.cx
    v = cam.fy * y / zs + cam.cy
    ur = ul - cam.fx * cam.baseline / zs
    return jnp.stack([ul, v, ur], axis=-1)


def backproject(cam: StereoCamera, uv, depth):
    """Pixels (..., 2) + depth (...,) → camera-frame points (..., 3).

    Equivalent of DepthCamera::pixel2camera."""
    d = depth[..., None]
    x = (uv[..., 0:1] - cam.cx) / cam.fx * d
    y = (uv[..., 1:2] - cam.cy) / cam.fy * d
    return jnp.concatenate([x, y, d], axis=-1)


def unit_ray(cam: StereoCamera, uv):
    """Pixels → normalized-plane rays (..., 3) with z=1."""
    x = (uv[..., 0:1] - cam.cx) / cam.fx
    y = (uv[..., 1:2] - cam.cy) / cam.fy
    return jnp.concatenate([x, y, jnp.ones_like(x)], axis=-1)


def disparity_to_depth(cam: StereoCamera, disparity):
    """Rectified stereo: z = fx·b / d, guarded."""
    d = jnp.maximum(disparity, 1e-3)
    return cam.fx * cam.baseline / d


def world_to_cam(T_c_w: SE3, pts_w):
    """World points → camera frame (DepthCamera::world2cameraT equivalent)."""
    return se3m.transform_points(T_c_w, pts_w)


def cam_to_world(T_c_w: SE3, pts_c):
    return se3m.transform_points(se3m.inverse(T_c_w), pts_c)


def project_world(cam: StereoCamera, T_c_w: SE3, pts_w):
    """World points → cam0 pixels (world2pixelT equivalent)."""
    return project(cam, world_to_cam(T_c_w, pts_w))


def in_bounds(cam: StereoCamera, uv, margin=0.0):
    """Validity mask for pixel coords, used for border culling
    (cf. /root/reference/src/processing/lkorb_tracking.cpp:98-125)."""
    return (
        (uv[..., 0] >= margin)
        & (uv[..., 0] <= cam.width - 1 - margin)
        & (uv[..., 1] >= margin)
        & (uv[..., 1] <= cam.height - 1 - margin)
    )
