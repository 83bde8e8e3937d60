"""Grid-bucketed Shi-Tomasi corner detection.

Array-native replacement for the reference's FeatureDEM
(/root/reference/src/processing/feature_dem.cpp: detect 215-266, redetect
124-213, calHarrisR 59-88): cv::goodFeaturesToTrack over the whole image,
features binned into a 4×4 grid of cells (16 regions,
include/feature_dem.h:16-21), per-cell cap with Harris-response ranking and
min-distance suppression against already-tracked points.

Here the entire thing is one fused program: a conv-based min-eigenvalue
response map, max-pool non-maximum suppression at the min-distance radius, a
distance-transform-free suppression of pixels near live tracks (computed as a
per-candidate distance test against the fixed-capacity landmark table), and a
per-cell top-k.  Output shape is static: (rows*cols*per_cell, ...) candidate
slots with a validity mask.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from . import image as imops


@dataclasses.dataclass(frozen=True)
class DetectParams:
    grid_rows: int = 4
    grid_cols: int = 4
    per_cell: int = 16               # max features per cell (ref f_para "max per region")
    min_distance: float = 15.0       # suppression radius, px (ref gftt minDistance)
    quality_level: float = 0.01      # relative response threshold (gftt default-ish)
    margin: int = 20                 # image border exclusion, px
    block_radius: int = 1            # structure-tensor window radius (gftt blockSize=3)


def shi_tomasi_response(img, block_radius: int = 1):
    """Min-eigenvalue corner response map (cv::cornerMinEigenVal equivalent).

    Structure tensor from Sobel gradients, box-summed over the block window;
    response = λ_min = (a+c)/2 − sqrt(((a−c)/2)² + b²).
    """
    ix, iy = imops.sobel_gradients(img)
    a = imops.box_filter(ix * ix, block_radius)
    b = imops.box_filter(ix * iy, block_radius)
    c = imops.box_filter(iy * iy, block_radius)
    half_tr = 0.5 * (a + c)
    return half_tr - jnp.sqrt(jnp.maximum((0.5 * (a - c)) ** 2 + b * b, 0.0))


def _window_max_1d(x, radius: int, axis: int):
    """Sliding max over a (2r+1) window along `axis` by doubling shifts —
    O(log r) full-array max ops instead of a (2r+1)-tap reduce_window."""
    def shift(a, off):
        pad = [(0, 0), (0, 0)]
        if off > 0:
            pad[axis] = (off, 0)
            sl = [slice(None), slice(None)]
            sl[axis] = slice(0, a.shape[axis])
            return jnp.pad(a, pad, constant_values=-jnp.inf)[tuple(sl)]
        pad[axis] = (0, -off)
        sl = [slice(None), slice(None)]
        sl[axis] = slice(-off, a.shape[axis] - off)
        return jnp.pad(a, pad, constant_values=-jnp.inf)[tuple(sl)]

    # Build max over [0, r] forward via doubling, then combine with the
    # mirrored backward max.
    fwd = x
    span = 1
    while span < radius + 1:
        step = min(span, radius + 1 - span)
        fwd = jnp.maximum(fwd, shift(fwd, -step))
        span += step
    bwd = x
    span = 1
    while span < radius + 1:
        step = min(span, radius + 1 - span)
        bwd = jnp.maximum(bwd, shift(bwd, step))
        span += step
    return jnp.maximum(fwd, bwd)


def _nms(resp, radius: int):
    """Keep only pixels that are the maximum of their (2r+1)² neighbourhood
    (separable doubling-shift max in each direction)."""
    pooled = _window_max_1d(resp, radius, axis=1)
    pooled = _window_max_1d(pooled, radius, axis=0)
    return jnp.where(resp >= pooled, resp, -jnp.inf)


@functools.partial(jax.jit, static_argnames=("params",))
def detect_grid_features(img, existing_uv, existing_mask, params: DetectParams = DetectParams()):
    """Detect up to rows*cols*per_cell new corners in empty grid capacity.

    Args:
      img: (H, W) float32 grayscale.
      existing_uv: (M, 2) live track positions to suppress around.
      existing_mask: (M,) bool validity of those tracks.
    Returns:
      uv: (rows*cols*per_cell, 2) candidate positions [x, y].
      score: matching responses.
      valid: bool mask (response above threshold, inside margins, not near a
        live track, cell-capacity respected).
    Candidates are ordered cell-major then score-descending, mirroring the
    reference's per-region sort (feature_dem.cpp:59-121).
    """
    h, w = img.shape
    rows, cols, k = params.grid_rows, params.grid_cols, params.per_cell

    resp = shi_tomasi_response(img, params.block_radius)

    # Border margin + global quality threshold.
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    m = params.margin
    border_ok = (yy >= m) & (yy < h - m) & (xx >= m) & (xx < w - m)
    thresh = params.quality_level * jnp.max(resp)
    resp = jnp.where(border_ok & (resp > thresh), resp, -jnp.inf)

    # NMS at roughly the min-distance radius enforces spacing between new
    # detections without a sequential greedy pass.
    resp = _nms(resp, max(int(params.min_distance // 2), 1))

    # Suppress around live tracks: for each live point, zero a disk.  Done as
    # a scatter of -inf into a low-res occupancy grid then upsampled test —
    # cheaper: per-candidate distance check after top-k (below), since the
    # candidate count is small and static.

    # Per-cell top-k.  Pad so the image divides evenly into the grid.
    ch = -(-h // rows)
    cw = -(-w // cols)
    padded = jnp.full((ch * rows, cw * cols), -jnp.inf, resp.dtype).at[:h, :w].set(resp)
    cells = padded.reshape(rows, ch, cols, cw).transpose(0, 2, 1, 3).reshape(rows * cols, ch * cw)
    top_val, top_idx = jax.lax.top_k(cells, k)          # (cells, k)
    cy = top_idx // cw
    cx = top_idx % cw
    cell_r = jnp.arange(rows * cols) // cols
    cell_c = jnp.arange(rows * cols) % cols
    px = (cell_c[:, None] * cw + cx).astype(jnp.float32)
    py = (cell_r[:, None] * ch + cy).astype(jnp.float32)
    uv = jnp.stack([px, py], axis=-1).reshape(-1, 2)
    score = top_val.reshape(-1)
    valid = jnp.isfinite(score)

    # Reject candidates within min_distance of any live track.
    d2 = jnp.sum((uv[:, None, :] - existing_uv[None, :, :]) ** 2, axis=-1)
    d2 = jnp.where(existing_mask[None, :], d2, jnp.inf)
    clear = jnp.min(d2, axis=-1, initial=jnp.inf) > params.min_distance ** 2
    valid = valid & clear

    return uv, jnp.where(valid, score, 0.0), valid


def count_per_cell(uv, mask, img_shape, params: DetectParams = DetectParams()):
    """How many live tracks fall in each grid cell — the redetect trigger
    metric (the reference redetects when a region is under-populated,
    feature_dem.cpp:124-213)."""
    h, w = img_shape
    ch = -(-h // params.grid_rows)
    cw = -(-w // params.grid_cols)
    r = jnp.clip((uv[:, 1] // ch).astype(jnp.int32), 0, params.grid_rows - 1)
    c = jnp.clip((uv[:, 0] // cw).astype(jnp.int32), 0, params.grid_cols - 1)
    cell = r * params.grid_cols + c
    counts = jnp.zeros(params.grid_rows * params.grid_cols, jnp.int32)
    return counts.at[cell].add(mask.astype(jnp.int32))
