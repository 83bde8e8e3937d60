"""Core batched image operations: pyramids, gradients, bilinear sampling.

These replace the OpenCV primitives the reference leans on
(cv::buildOpticalFlowPyramid inside calcOpticalFlowPyrLK, cv::equalizeHist at
/root/reference/src/frontend/f2f_tracking.cpp:127-144) with fixed-shape JAX
ops that XLA fuses.

Images are single-channel float32 arrays (H, W) in [0, 255].  All sampling
is clamp-to-edge.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# 5-tap binomial kernel used by cv::pyrDown.
_PYR_K = np.asarray([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


def _sep_filter(img, kx, ky):
    """Separable 2D filter with edge-replicate padding over the last two
    dims, (..., H, W) → (..., H, W).  Leading dims batch — the tracker
    stacks the stereo pair so both images ride one fused pass.

    Implemented as shift-and-add over statically-sliced views rather than
    lax.conv: weighted sums of shifted full-size arrays are elementwise
    work that XLA fuses into a handful of passes, with no single-channel
    convolution lowering in between.
    """
    rx = int(kx.shape[0]) // 2
    ry = int(ky.shape[0]) // 2
    h, w = img.shape[-2:]
    nb = img.ndim - 2
    kxv = [float(v) for v in np.asarray(kx)]
    kyv = [float(v) for v in np.asarray(ky)]

    p = jnp.pad(img, ((0, 0),) * nb + ((0, 0), (rx, rx)), mode="edge")
    acc = None
    for i, wgt in enumerate(kxv):
        term = p[..., :, i:i + w] * wgt
        acc = term if acc is None else acc + term
    p = jnp.pad(acc, ((0, 0),) * nb + ((ry, ry), (0, 0)), mode="edge")
    acc = None
    for i, wgt in enumerate(kyv):
        term = p[..., i:i + h, :] * wgt
        acc = term if acc is None else acc + term
    return acc


def pyr_down(img):
    """Gaussian blur + 2× decimation (cv::pyrDown equivalent)."""
    blurred = _sep_filter(img, _PYR_K, _PYR_K)
    return blurred[..., ::2, ::2]


def build_pyramid(img, num_levels: int):
    """List of `num_levels` images, level 0 = full resolution."""
    levels = [img]
    for _ in range(num_levels - 1):
        levels.append(pyr_down(levels[-1]))
    return levels


def build_grad_pyramid(img, num_levels: int):
    """Pyramid with per-level Scharr gradients: tuple of (img, gx, gy).

    Computed ONCE per frame and reused by every LK pass over that image
    (temporal track + stereo forward + stereo backward).  Leading dims batch
    (the tracker passes its (3, H, W) stack).
    """
    out = []
    level = img
    for l in range(num_levels):
        gx, gy = scharr_gradients(level)
        out.append((level, gx, gy))
        if l + 1 < num_levels:
            level = pyr_down(level)
    return tuple(out)


def scharr_gradients(img):
    """(Ix, Iy) via the 3×3 Scharr operator (OpenCV's LK derivative choice)."""
    smooth = np.asarray([3.0, 10.0, 3.0], np.float32) / 32.0
    diff = np.asarray([-1.0, 0.0, 1.0], np.float32)
    ix = _sep_filter(img, diff, smooth)
    iy = _sep_filter(img, smooth, diff)
    return ix, iy


def sobel_gradients(img):
    smooth = np.asarray([1.0, 2.0, 1.0], np.float32) / 4.0
    diff = np.asarray([-1.0, 0.0, 1.0], np.float32) / 2.0
    ix = _sep_filter(img, diff, smooth)
    iy = _sep_filter(img, smooth, diff)
    return ix, iy


def box_filter(img, radius: int):
    k = np.ones(2 * radius + 1, np.float32) / (2 * radius + 1)
    return _sep_filter(img, k, k)


def bilinear_sample(img, xy):
    """Sample img (H, W) at subpixel locations xy (..., 2) [x, y] order.

    Clamp-to-edge; pure gathers so it vectorises over any batch shape.
    """
    h, w = img.shape
    x = jnp.clip(xy[..., 0], 0.0, w - 1.000001)
    y = jnp.clip(xy[..., 1], 0.0, h - 1.000001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, w - 1)
    y1 = jnp.minimum(y0 + 1, h - 1)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x1]
    v10 = img[y1, x0]
    v11 = img[y1, x1]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def extract_patches(img, centers, radius: int):
    """Subpixel square patches around centers.

    Args:
      img: (H, W).
      centers: (N, 2) [x, y] patch centers (subpixel).
      radius: patch half-size; patch side = 2*radius + 1.
    Returns:
      (N, S, S) patch values, S = 2*radius+1.

    Implementation note: one (S+1, S+1) block gather per point via
    `_gather_blocks` followed by a 4-tap bilinear blend with per-point
    fractional weights — not a per-pixel gather for each of the (S+1)²
    samples.  The image is edge-replicate padded by
    radius+2 first so patches that straddle the border replicate edge
    pixels exactly like per-pixel clamped gathers would.
    """
    h, w = img.shape
    s = 2 * radius + 1
    pad = radius + 2
    imgp = jnp.pad(img, pad, mode="edge")
    x = jnp.clip(centers[:, 0], -1.0, w * 1.0)
    y = jnp.clip(centers[:, 1], -1.0, h * 1.0)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[:, None, None]
    fy = (y - y0)[:, None, None]
    # With the clip above, slice starts lie in [pad-1-radius, dim+pad-radius]
    # and fit entirely inside the padded image — no implicit clamping.
    xi = x0.astype(jnp.int32) - radius + pad
    yi = y0.astype(jnp.int32) - radius + pad

    P = _gather_blocks(imgp, xi, yi, s + 1)  # (N, S+1, S+1)
    return (
        P[:, :-1, :-1] * (1 - fx) * (1 - fy)
        + P[:, :-1, 1:] * fx * (1 - fy)
        + P[:, 1:, :-1] * (1 - fx) * fy
        + P[:, 1:, 1:] * fx * fy
    )


def extract_patches_int(img, centers, radius: int):
    """Integer-centered square patches: like extract_patches but for INTEGER
    pixel centers (e.g. FAST corners) — skips the 4-term bilinear blend and
    the (S+1, S+1) over-gather entirely, returning (N, S, S) blocks."""
    h, w = img.shape
    s = 2 * radius + 1
    pad = radius + 1
    imgp = jnp.pad(img, pad, mode="edge")
    xi = jnp.clip(centers[:, 0].astype(jnp.int32), -1, w) - radius + pad
    yi = jnp.clip(centers[:, 1].astype(jnp.int32), -1, h) - radius + pad
    return _gather_blocks(imgp, xi, yi, s)


def _gather_blocks(padded, cx, cy, size: int):
    """(N,) int32 padded-space corners → per-point blocks from `padded`
    ((H, W) → (N, size, size); (C, H, W) → (N, C, size, size)).

    A vmap of dynamic_slice, which XLA lowers to one gather whose work is
    N·C·size² — independent of the image size.  dynamic_slice clamps a
    start so the block stays inside `padded`; callers pad and pre-clip so
    that clamping never triggers.
    """
    if padded.ndim == 2:
        return jax.vmap(
            lambda yy, xx: jax.lax.dynamic_slice(padded, (yy, xx), (size, size))
        )(cy, cx)
    c = padded.shape[0]
    return jax.vmap(
        lambda yy, xx: jax.lax.dynamic_slice(padded, (0, yy, xx), (c, size, size))
    )(cy, cx)


def extract_patches_multi(stack, centers, radius: int):
    """Multi-channel extract_patches: ONE block gather per point for all
    channels (a (C, S+1, S+1) block), instead of C separate gather passes.

    Args:
      stack: (C, H, W) channel-stacked image (e.g. img/gx/gy).
      centers: (N, 2) [x, y] subpixel centers.
      radius: patch half-size.
    Returns: (N, C, S, S), S = 2*radius+1.
    """
    c, h, w = stack.shape
    s = 2 * radius + 1
    pad = radius + 2
    sp = jnp.pad(stack, ((0, 0), (pad, pad), (pad, pad)), mode="edge")
    x = jnp.clip(centers[:, 0], -1.0, w * 1.0)
    y = jnp.clip(centers[:, 1], -1.0, h * 1.0)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[:, None, None, None]
    fy = (y - y0)[:, None, None, None]
    xi = x0.astype(jnp.int32) - radius + pad
    yi = y0.astype(jnp.int32) - radius + pad
    P = _gather_blocks(sp, xi, yi, s + 1)  # (N, C, S+1, S+1)
    return (
        P[:, :, :-1, :-1] * (1 - fx) * (1 - fy)
        + P[:, :, :-1, 1:] * fx * (1 - fy)
        + P[:, :, 1:, :-1] * (1 - fx) * fy
        + P[:, :, 1:, 1:] * fx * fy
    )


def extract_windows(img, corners, window: int):
    """Integer-aligned square windows: one block gather per point from the
    edge-padded image.  corners are INTEGER top-left image coords (may be
    negative — edge padding absorbs out-of-image parts).

    Returns (windows (N, window, window), corners_eff (N, 2)) where
    corners_eff are the possibly-clamped top-left coords actually used —
    sample positions must be taken relative to these.  Used by the LK
    search-window scheme: gather the window ONCE, then every Gauss-Newton
    iteration samples inside it with bilinear selection matmuls instead of
    new gathers (ops/lk.py).
    """
    h, w = img.shape
    pad = window  # enough for any clamped corner
    ip = jnp.pad(img, pad, mode="edge")
    cx = jnp.clip(corners[:, 0].astype(jnp.int32), -pad, w)
    cy = jnp.clip(corners[:, 1].astype(jnp.int32), -pad, h)
    wins = _gather_blocks(ip, cx + pad, cy + pad, window)
    return wins, jnp.stack([cx, cy], axis=-1)


def equalize_hist(img):
    """Global 256-bin histogram equalization (cv::equalizeHist equivalent,
    used when the YAML blur gate triggers, /root/reference/src/frontend/
    f2f_tracking.cpp:127-148): lut[b] = round(255 · (cdf[b] − cdf_min) /
    (N − cdf_min)), in integer arithmetic so every device rounds alike.

    Both the histogram and the LUT application run on one-hot encodings,
    not scatter-add / gather: the 256-wide one-hot is factorized into two
    16-wide ones (bin = 16*hi + lo), so the histogram is ONE matmul
    (oh_hi^T @ oh_lo, contracted over pixels) and the LUT application a
    K=16 matmul + masked reduce.  Exact: 0/1 one-hots are exact in bf16,
    integer counts < 2^24 are exact in the f32 accumulator, and each LUT
    output is a single nonzero integer term.

    The last two dims are the image; leading dims batch with an independent
    histogram each (the tracker stacks the stereo pair into one call)."""
    idx = jnp.clip(img, 0.0, 255.0).astype(jnp.int32)
    hi = idx >> 4
    lo = idx & 15
    a16 = jnp.arange(16, dtype=jnp.int32)
    oh_hi = (hi[..., None] == a16).astype(jnp.bfloat16)        # (..., H, W, 16)
    oh_lo = (lo[..., None] == a16).astype(jnp.bfloat16)
    hist2 = jnp.einsum("...hwa,...hwb->...ab", oh_hi, oh_lo,
                       preferred_element_type=jnp.float32)     # (..., 16, 16)
    hist = hist2.reshape(*hist2.shape[:-2], 256)               # hi-major == bin order
    cdf = jnp.cumsum(hist.astype(jnp.int32), axis=-1)
    first = jnp.argmax(cdf > 0, axis=-1)[..., None]
    cdf_min = jnp.take_along_axis(cdf, first, axis=-1)         # (..., 1)
    denom = jnp.maximum(cdf[..., -1:] - cdf_min, 1)
    lut = jnp.clip(((cdf - cdf_min) * 255 + denom // 2) // denom, 0, 255)
    L = lut.astype(jnp.float32).reshape(*lut.shape[:-1], 16, 16)
    t = jnp.einsum("...hwa,...ab->...hwb", oh_hi.astype(jnp.float32), L,
                   precision="highest")
    return jnp.sum(t * oh_lo.astype(jnp.float32), axis=-1)


@functools.partial(jax.jit, static_argnames=("sigma", "ksize"))
def gaussian_blur(img, sigma: float = 1.0, ksize: int = 5):
    r = ksize // 2
    xs = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / float(sigma)) ** 2)
    k = k / np.sum(k)
    return _sep_filter(img, k, k)
