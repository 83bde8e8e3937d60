"""Dense plane-sweep block-matching stereo — regular-grid disparity.

Replaces the loop node's per-keypoint stereo LK for ORB keypoint depth
recovery (the reference runs cv::calcOpticalFlowPyrLK left→right on its
1000 ORB points, /root/reference/src/backend/vo_loopclosing.cpp:262-283).
Iterative per-point LK at this point count re-gathers 1000 image patches
per Gauss-Newton iteration — linear in N and serial in the iteration
chain.  A dense plane sweep is the data-parallel dual: for D candidate
disparities, the matching cost |L − shift(R, d)| box-filtered over the
support window is full-width elementwise work (shift-and-add slices, the
ops/image._sep_filter idiom — no per-point gathers at all), the winner is
an argmin over the (D, H, W) volume, and per-keypoint depth becomes a
cheap bilinear read of the disparity map.  Its cost is INDEPENDENT of the
keypoint count.

Accuracy: half-res integer disparity + 3-point parabolic subpixel ≈ ±0.25
half-res px ≈ ±0.5 full-res px — the same grade as the 31×31 LK it
replaces for PnP-anchor purposes (loop verification gates at 3 px).  The
frontend's landmark depth keeps its LK path (256 points, IIR-fused,
accuracy-critical); this module serves the loop node's bulk recovery.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import image as imops


def _box2d(vol, radius: int):
    """Separable box sum over the last two dims of (..., H, W) — shift-and-
    add slices (see image._sep_filter for why not lax.conv).

    radius=4 fast path: a 9-tap box factors EXACTLY as a 3-tap sum composed
    with a 3-tap sum dilated by 3, cutting the adds from 8 to 4 per
    axis.  Edge-replicate padding is applied
    up front so the composition matches the single-stage filter everywhere,
    border included."""
    if radius == 4:
        nb = vol.ndim - 2
        p = jnp.pad(vol, ((0, 0),) * nb + ((4, 4), (4, 4)), mode="edge")

        def tap3(v, axis, d):
            def sub(lo):
                s = [slice(None)] * v.ndim
                hi = lo - 2 * d
                s[axis] = slice(lo, hi if hi != 0 else None)
                return v[tuple(s)]

            return sub(0) + sub(d) + sub(2 * d)

        def s9(v, axis):
            return tap3(tap3(v, axis, 1), axis, 3)

        return s9(s9(p, vol.ndim - 1), vol.ndim - 2)
    k = np.ones(2 * radius + 1, np.float32)
    return imops._sep_filter(vol, k, k)


@functools.partial(jax.jit, static_argnames=("d_max", "radius"))
def disparity_sweep(img_l, img_r, d_max: int = 64, radius: int = 4):
    """Half-resolution plane-sweep disparity for a rectified pair.

    Args:
      img_l/img_r: (H, W) float32 rectified intensity images.
      d_max: number of candidate integer disparities at HALF resolution
        (covers [0, 2·d_max) full-res disparity).
      radius: box-matching window radius at half resolution.
    Returns (disp, valid): FULL-resolution-scale disparity (H/2, W/2) and a
    validity mask (textured, unambiguous, in-range matches).
    """
    # 2×2 mean decimation: cheap anti-alias + halves the sweep volume.
    # RESHAPE-mean, not stride-2 slices: a strided slice feeding all 64
    # shifted volume slices can be re-evaluated per consumer, while the
    # (h2, 2, w2, 2) reshape + mean is one pass.
    def half(a):
        h2, w2 = a.shape[0] // 2, a.shape[1] // 2
        a = a[: 2 * h2, : 2 * w2]
        return a.reshape(h2, 2, w2, 2).mean(axis=(1, 3))

    L, R = half(img_l), half(img_r)
    Hh, Wh = L.shape
    # Cost volume: SAD of L vs R shifted right by d (replicate out-of-range).
    # bf16 halves the volume's HBM traffic — the sweep is bandwidth-bound
    # and SAD winners are separated by whole intensity units, far above
    # bf16's ~0.4-unit rounding.
    Rp = jnp.pad(R, ((0, 0), (d_max, 0)), mode="edge")
    shifted = jnp.stack([Rp[:, d_max - d: d_max - d + Wh]
                         for d in range(d_max)])          # (D, Hh, Wh)
    # The cost volume stays bf16 END-TO-END (not just through the box
    # filter): the argmin/min/neighbour reductions below re-read the whole
    # (D, Hh, Wh) volume, so an f32 copy doubles their HBM traffic for
    # precision the parabola doesn't need — near a good minimum the SAD is
    # O(10²-10³) where bf16 rounds by ≲4 units, a few % of the cm/cp
    # curvature the subpixel fit divides by (±0.02 half-px on a ±0.25 fit).
    cost = _box2d(jnp.abs(L[None] - shifted).astype(jnp.bfloat16), radius)

    best = jnp.argmin(cost, axis=0)                       # (Hh, Wh)
    d_idx = jnp.arange(d_max)[:, None, None]
    c_best = jnp.min(cost, axis=0).astype(jnp.float32)
    # Neighbour costs via one-hot masked reductions, which fuse with the
    # volume read instead of a per-pixel take_along_axis gather.
    db = d_idx - best[None]                               # (D, Hh, Wh)
    zero = jnp.bfloat16(0)
    cm = jnp.sum(jnp.where(db == -1, cost, zero), axis=0,
                 dtype=jnp.float32)
    cp = jnp.sum(jnp.where(db == 1, cost, zero), axis=0,
                 dtype=jnp.float32)
    # 3-point parabolic subpixel around the winner.
    denom = cm + cp - 2.0 * c_best
    delta = jnp.where(denom > 1e-3, 0.5 * (cm - cp) / jnp.maximum(denom, 1e-3), 0.0)
    delta = jnp.clip(delta, -0.5, 0.5)
    disp_h = best.astype(jnp.float32) + delta

    # Validity: enough texture (window intensity spread), an unambiguous
    # minimum (margin vs the best far-away candidate), and not clamped at
    # the sweep edges.
    # box_filter returns the local MEAN (its kernel is /(2r+1) per axis), so
    # |L - mean| is the pointwise absolute deviation; box-summing it gives
    # area x (mean absolute deviation), gated against 4 intensity units.
    area = float((2 * radius + 1) ** 2)
    texture = _box2d(jnp.abs(L - imops.box_filter(L, radius)), radius)
    c_second = jnp.min(jnp.where(jnp.abs(db) > 2, cost,
                                 jnp.bfloat16(jnp.inf)), axis=0)
    c_second = c_second.astype(jnp.float32)
    valid = ((texture > 4.0 * area)
             & (c_second > 1.05 * c_best + 1e-3)
             & (best > 0) & (best < d_max - 1))
    return 2.0 * disp_h, valid                            # full-res scale


def keypoint_disparity(disp, valid, uv):
    """Sample the half-res sweep at FULL-res keypoint coords uv (N, 2).
    Returns (disparity (N,), ok (N,)) in full-resolution pixels."""
    uv_h = uv * 0.5
    d = imops.bilinear_sample(disp, uv_h)
    v = imops.bilinear_sample(valid.astype(jnp.float32), uv_h)
    return d, v > 0.999          # all four support pixels valid
