"""Batched ORB features: FAST corners + intensity-centroid orientation +
rotated BRIEF descriptors.

Array-native replacement for cv::ORB::detectAndCompute as used by the
reference's loop-closing node (1000 features per keyframe,
/root/reference/src/backend/vo_loopclosing.cpp:243-245) and BFMatcher
Hamming matching (vo_loopclosing.cpp:603-660).

Design notes (everything fixed-shape, no data-dependent control flow):
  - FAST-9 is evaluated for EVERY pixel at once: the 16 Bresenham-circle
    samples become 16 shifted copies of the image; the "9 contiguous"
    test is 9 rolled ANDs of the 32-bit doubled mask — pure elementwise
    work that XLA fuses.
  - Orientation uses image moments over a circular patch computed with two
    small convolutions (x- and y-weighted kernels), sampled at keypoints.
  - Descriptors: the 256 BRIEF point pairs are rotated per-keypoint and
    sampled bilinearly from the blurred image; bits are packed into
    (N, 8) uint32 so Hamming distance is XOR + population_count.
  - Matching: packed XOR+popcount for pairwise distance matrices; for
    vocabulary-sized comparisons, unpack_pm1() yields ±1 floats so word
    assignment runs as a plain matmul.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import image as imops

# --- FAST circle offsets (radius-3 Bresenham, OpenCV order) ---------------
_CIRCLE = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
])


def fast_score(img, threshold: float = 20.0):
    """FAST-9 corner response for every pixel, (H, W).

    Response is 0 for non-corners; for corners it is the sum-of-absolute-
    differences of the contiguous arc (OpenCV's FAST score flavour).
    """
    shifted = [jnp.roll(img, (-dy, -dx), axis=(0, 1)) for (dx, dy) in _CIRCLE]
    ring = jnp.stack(shifted, axis=0)                    # (16, H, W)
    diff = ring - img[None, :, :]
    bright = diff > threshold
    dark = diff < -threshold

    def arc9(mask):
        # mask: (16, H, W) bool → any 9-contiguous run on the circle.
        m = mask
        acc = m
        for k in range(1, 9):
            acc = acc & jnp.roll(m, -k, axis=0)
        return jnp.any(acc, axis=0)

    is_corner = arc9(bright) | arc9(dark)
    score = jnp.sum(jnp.where(bright | dark, jnp.abs(diff) - threshold, 0.0), axis=0)
    return jnp.where(is_corner, score, 0.0)


def _moment_kernels(radius: int = 15):
    ys, xs = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    disk = (xs ** 2 + ys ** 2 <= radius ** 2).astype(np.float32)
    return (xs * disk).astype(np.float32), (ys * disk).astype(np.float32)


def orientations_from_patches(patches, radius: int | None = None):
    """IC angle from pre-extracted (N, S, S) patches with S ≥ 2·radius+1
    (centre-cropped) — lets detect_and_compute share ONE patch gather
    between orientation and BRIEF instead of extracting twice.  With
    radius=None the full patch is the moment disk (the shared 27×27 ORB
    patch gives radius 13; OpenCV's IC_Angle uses 15 — the centroid is a
    ~530-pixel low-pass statistic either way, angle deviation <1° on
    textured patches)."""
    S = patches.shape[-1]
    if radius is None:
        radius = (S - 1) // 2
    c = (S - (2 * radius + 1)) // 2
    p = patches[:, c:c + 2 * radius + 1, c:c + 2 * radius + 1]
    kx, ky = _moment_kernels(radius)
    m10 = jnp.einsum("nyx,yx->n", p, jnp.asarray(kx), precision="highest")
    m01 = jnp.einsum("nyx,yx->n", p, jnp.asarray(ky), precision="highest")
    return jnp.arctan2(m01, m10)


def orientations(img, pts, radius: int | None = None):
    """Intensity-centroid angle θ = atan2(m01, m10) per keypoint (IC_Angle).

    Default radius is _PATCH_R (13) — the SAME disk detect_and_compute's
    shared-patch path uses, so angles (and therefore descriptors) agree
    across the two paths.  (OpenCV's IC_Angle uses 15; the centroid is a
    ~530-pixel low-pass statistic either way.)

    Per-keypoint (2r+1)² patches (one block gather) contracted with the
    constant disk moment kernels — per-keypoint work instead of two
    whole-image 31×31 convolutions sampled at the keypoints, and
    bit-identical to them for keypoints ≥ radius from the border (detection
    excludes the border)."""
    if radius is None:
        radius = _PATCH_R
    patches = imops.extract_patches(img, pts, radius)     # (N, S, S)
    return orientations_from_patches(patches, radius)


def _brief_pattern(num_pairs: int = 256, patch: int = 24, seed: int = 42):
    """Gaussian BRIEF sampling pairs, (P, 4) = (x1, y1, x2, y2).

    Endpoints are clipped per-coordinate to ±patch/2, then NORM-clipped to
    radius patch/2: a corner-of-the-box point would sweep out to
    (patch/2)·√2 under rotation, forcing the shared orientation+BRIEF patch
    to radius 19; pulling the ~4% of endpoints with ‖p‖ > patch/2 back onto
    the radius-12 circle (a ≤41% radial shrink on those few) bounds the
    rotated support to ±12 and lets the patch shrink to 27×27 — halving
    the MACs in the dominant per-keypoint gather and sampling matmuls."""
    rng = np.random.default_rng(seed)
    pat = rng.normal(0.0, patch / 5.0, size=(num_pairs, 4))
    pat = np.clip(pat, -patch / 2, patch / 2)
    for k in (0, 2):                       # endpoints (x1,y1), (x2,y2)
        n = np.hypot(pat[:, k], pat[:, k + 1])
        scale = np.minimum(1.0, (patch / 2) / np.maximum(n, 1e-6))
        pat[:, k] *= scale
        pat[:, k + 1] *= scale
    return pat.astype(np.float32)


_PATTERN = _brief_pattern()
# Patch half-size for the shared orientation+BRIEF gather: rotated BRIEF
# support is ≤12 (norm-clipped pattern) + 1 for bilinear interpolation.
_PATCH_R = 13


def brief_descriptors(img_blur, pts, angles):
    """Rotated BRIEF-256, packed to (N, 8) uint32.

    img_blur should be a Gaussian-smoothed image (ORB blurs before BRIEF).

    One (2r+1)² patch per keypoint (block gather), then all 512 rotated
    sample positions evaluated INSIDE the patches with bilinear
    hat-function selection — a batched (N,512,S)×(N,S,S) matmul for the row
    interpolation and a reduction for the columns, instead of N·512
    scattered 4-tap image gathers.  Matches per-position `bilinear_sample`
    to bf16 rounding (≲0.5 intensity unit — see brief_from_patches) for
    keypoints ≥ r from the border (detection excludes them).
    """
    patches = imops.extract_patches(img_blur, pts, _PATCH_R)     # (N, S, S)
    return brief_from_patches(patches, angles)


def brief_from_patches(patches, angles):
    """Rotated BRIEF-256 from pre-extracted (N, S, S) blurred patches with
    S ≥ 27 (see brief_descriptors; split out so detect_and_compute can share
    one patch gather with the orientation stage).  The patch half-size is
    inferred from the patch shape."""
    r = (patches.shape[-1] - 1) // 2
    pat = jnp.asarray(_PATTERN)                       # (256, 4)
    ca, sa = jnp.cos(angles), jnp.sin(angles)         # (N,)
    xs = jnp.concatenate([pat[:, 0], pat[:, 2]])      # (512,)
    ys = jnp.concatenate([pat[:, 1], pat[:, 3]])
    rx = ca[:, None] * xs[None, :] - sa[:, None] * ys[None, :]   # (N, 512)
    ry = sa[:, None] * xs[None, :] + ca[:, None] * ys[None, :]

    # Offsets lie within ±12 after rotation (norm-clipped pattern); the
    # patch radius covers the bilinear support.
    s = 2 * r + 1
    py = jnp.clip(ry + r, 0.0, s - 1.000001)
    px = jnp.clip(rx + r, 0.0, s - 1.000001)
    grid = jnp.arange(s, dtype=jnp.float32)
    wy = jnp.maximum(0.0, 1.0 - jnp.abs(grid[None, None, :] - py[..., None]))
    wx = jnp.maximum(0.0, 1.0 - jnp.abs(grid[None, None, :] - px[..., None]))
    # ONE bf16 pass: each row has ≤2 nonzero hat weights, so the sample
    # rounds by ≲0.5 intensity unit — the same uint8-grade quantization the
    # reference's cv::ORB lives with (it samples integer pixels with no
    # interpolation at all).  Near-tie bits may flip vs an f32 sampling,
    # but database and query descriptors are computed identically, so
    # matching Hamming distances are unaffected in expectation.
    rows = jnp.einsum("npy,nyx->npx", wy, patches,
                      precision="default")                       # (N, 512, S)
    samples = jnp.sum(rows * wx, axis=-1)                        # (N, 512)
    bits = samples[:, :256] < samples[:, 256:]
    # Pack 256 bits → 8 uint32 words.
    b = bits.reshape(bits.shape[0], 8, 32).astype(jnp.uint32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, None, :]
    return jnp.sum(b * weights, axis=-1, dtype=jnp.uint32)  # (N, 8)


def fast_score_nms(img, threshold: float = 20.0, margin: int = 20):
    """FAST-9 response after 3×3 non-max suppression, zeroed within
    `margin` pixels of the border (BRIEF patch support), (H, W)."""
    h, w = img.shape
    raw = fast_score(img, threshold)
    pooled = jax.lax.reduce_window(
        raw, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    ok = ((yy >= margin) & (yy < h - margin)
          & (xx >= margin) & (xx < w - margin))
    return jnp.where((raw >= pooled) & ok, raw, 0.0)


@functools.partial(jax.jit, static_argnames=("num_features", "threshold"))
def detect_and_compute(img, num_features: int = 500, threshold: float = 20.0):
    """ORB pipeline: FAST-9 + NMS → top-K by score → orientation → rBRIEF.

    Returns (uv (K, 2), desc (K, 8) uint32, valid (K,), angles (K,)).
    Fixed output size with a validity mask — non-corners score 0 and are
    masked out.  Keypoints come in descending score order (exact top-k;
    ties go to the lower flat index).
    """
    w = img.shape[1]
    score = fast_score_nms(img, threshold)
    top_val, top_idx = jax.lax.top_k(score.reshape(-1), num_features)
    uv = jnp.stack([(top_idx % w).astype(jnp.float32),
                    (top_idx // w).astype(jnp.float32)], axis=-1)
    valid = top_val > 0.0

    # ONE shared (N, 27, 27) blurred-patch gather serves both the
    # orientation moments (full-patch disk) and rotated BRIEF — the
    # per-point patch gather is the dominant per-keypoint cost.  FAST
    # corners sit at integer pixels, so the gather skips subpixel blending
    # (extract_patches_int), and exact=False runs its selection matmuls in
    # one bf16 pass per operand (≤0.5-unit rounding on blurred [0,255]
    # data — the reference's cv::ORB samples uint8 with no interpolation).
    # Computing IC_Angle on the σ=2-blurred patch instead of the raw image
    # deviates from the reference's raw-image moments by <1° on textured
    # patches (the centroid is a low-pass statistic already); BRIEF bits
    # are computed on the blurred patch in both formulations.
    blur = imops.gaussian_blur(img, sigma=2.0, ksize=7)
    patches = imops.extract_patches_int(blur, uv, _PATCH_R)
    ang = orientations_from_patches(patches)
    desc = brief_from_patches(patches, ang)
    return uv, desc, valid, ang


def hamming_matrix(desc_a, desc_b):
    """(Na, Nb) Hamming distances between packed (·, 8) uint32 descriptors:
    XOR + population_count, summed over the 8 words."""
    x = jnp.bitwise_xor(desc_a[:, None, :], desc_b[None, :, :])
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


def unpack_pm1(desc, dtype=jnp.float32):
    """(N, 8) uint32 → (N, 256) ±1 floats (for matmul comparisons:
    hamming = (256 − a·b)/2)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    return (bits.reshape(desc.shape[0], 256).astype(dtype) * 2.0 - 1.0)


def mutual_ratio_match(desc_a, desc_b, valid_a, valid_b, ratio: float = 0.75,
                       max_distance: int = 64):
    """Mutual-best kNN2 matching with Lowe ratio test.

    Replaces the reference's BFMatcher knn2 + mutual check + ratio gate
    (vo_loopclosing.cpp:603-660).  Returns (idx_b_for_a (Na,), good (Na,)).
    """
    d = hamming_matrix(desc_a, desc_b)
    big = jnp.int32(512)
    d = jnp.where(valid_a[:, None] & valid_b[None, :], d, big)
    # Two smallest along b for each a.
    neg_top2, idx_top2 = jax.lax.top_k(-d, 2)
    best_ab = idx_top2[:, 0]
    d1 = -neg_top2[:, 0]
    d2 = -neg_top2[:, 1]
    # Mutual check: a must also be b's best.
    best_ba = jnp.argmin(d, axis=0)
    mutual = best_ba[best_ab] == jnp.arange(d.shape[0])
    good = (
        valid_a & mutual
        & (d1 <= max_distance)
        & (d1.astype(jnp.float32) < ratio * jnp.maximum(d2, 1).astype(jnp.float32))
    )
    return best_ab, good
