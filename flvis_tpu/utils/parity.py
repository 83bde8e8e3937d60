"""Parity checks of the device ops against plain numpy references.

Each check builds its inputs from a seed at the engine's operating widths —
752×480 stereo, 256 landmark slots, 3 pyramid levels, ORB-1000, a 4096-word
vocabulary, a window of 10 keyframes × 600 landmarks — runs the op on JAX's
default device, and compares it with an independent numpy implementation
(float64 wherever rounding matters).  A check returns a one-line summary
(error, tolerance and the reason for that tolerance) and raises
AssertionError when the op disagrees.

The same functions run on the CPU in tests/test_parity.py and on the GPU
in chip_smoke.py and tests/test_chip.py.  A float32 matmul at DEFAULT
precision may run as TF32 on the GPU, so every comparison below is either
exact by construction (integer-valued or one-hot arithmetic, pinned
"highest" precision) or states the float32 error it allows.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

WIDTH, HEIGHT = 752, 480

# FAST-9 Bresenham circle of radius 3, clockwise from the top, as (dx, dy).
_FAST_CIRCLE = [(0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2),
                (1, 3), (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1),
                (-2, -2), (-1, -3)]


def stereo_frame(seed: int = 0):
    """One uint8-valued (left, right) float32 pair at 752×480 from the bench
    scene (textured plane 8 m away, 0.11 m baseline)."""
    from ..io.synthetic import PlanarScene, SceneConfig

    scfg = SceneConfig(width=WIDTH, height=HEIGHT, fx=458.0, fy=458.0,
                       cx=376.0, cy=240.0, baseline=0.11)
    left, right, _ = PlanarScene(scfg, plane_depth=8.0, seed=seed).render(
        np.eye(3), np.zeros(3))
    u8 = lambda a: np.clip(np.round(a), 0, 255).astype(np.float32)
    return u8(left), u8(right)


# --------------------------------------------------------------- references
def np_sep_filter(img, kx, ky):
    """Separable correlation with edge-replicate borders over the last two
    dims, in float64."""
    img = np.asarray(img, np.float64)
    h, w = img.shape[-2:]
    lead = [(0, 0)] * (img.ndim - 2)
    rx, ry = len(kx) // 2, len(ky) // 2
    p = np.pad(img, lead + [(0, 0), (rx, rx)], mode="edge")
    tmp = sum(k * p[..., :, i:i + w] for i, k in enumerate(kx))
    p = np.pad(tmp, lead + [(ry, ry), (0, 0)], mode="edge")
    return sum(k * p[..., i:i + h, :] for i, k in enumerate(ky))


def np_grad_pyramid(img, levels: int):
    """[(level, Scharr gx, Scharr gy)] with cv::pyrDown's 5-tap blur and
    even-sample decimation between levels."""
    diff = [-1.0, 0.0, 1.0]
    smooth = [3 / 32, 10 / 32, 3 / 32]
    pyr = [1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16]
    out, level = [], np.asarray(img, np.float64)
    for l in range(levels):
        out.append((level, np_sep_filter(level, diff, smooth),
                    np_sep_filter(level, smooth, diff)))
        if l + 1 < levels:
            level = np_sep_filter(level, pyr, pyr)[..., ::2, ::2]
    return out


def np_fast_nms(img, threshold: float = 20.0, margin: int = 20):
    """FAST-9 score (sum of |diff| − threshold over the circle pixels that
    pass) for pixels with a contiguous arc of ≥ 9 brighter or darker circle
    pixels, after 3×3 non-max suppression and a `margin` border mask."""
    img = np.asarray(img, np.float64)
    h, w = img.shape
    pad = np.pad(img, 3, mode="wrap")
    diffs = np.stack([pad[3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - img
                      for dx, dy in _FAST_CIRCLE])
    bright, dark = diffs > threshold, diffs < -threshold

    def has_arc9(mask):
        bits = np.zeros((h, w), np.int64)
        for k in range(16):
            bits |= mask[k].astype(np.int64) << k
        ring = bits | (bits << 16)
        run = ring.copy()
        for k in range(1, 9):
            run &= ring >> k
        return run != 0

    corner = has_arc9(bright) | has_arc9(dark)
    score = np.where(bright | dark, np.abs(diffs) - threshold, 0.0).sum(0)
    raw = np.where(corner, score, 0.0)
    p = np.pad(raw, 1, constant_values=-np.inf)
    pooled = np.max([p[dy:dy + h, dx:dx + w]
                     for dy in range(3) for dx in range(3)], axis=0)
    yy, xx = np.mgrid[:h, :w]
    inside = ((yy >= margin) & (yy < h - margin)
              & (xx >= margin) & (xx < w - margin))
    return np.where((raw >= pooled) & inside, raw, 0.0)


def np_disparity(img_l, img_r, d_max: int = 64, radius: int = 4):
    """Brute-force half-resolution SAD block matching: (full-res-scale
    disparity, validity), float64, same winner/subpixel/validity rules as
    ops.stereo.disparity_sweep."""
    def half(a):
        h2, w2 = a.shape[0] // 2, a.shape[1] // 2
        return np.asarray(a, np.float64)[:2 * h2, :2 * w2].reshape(
            h2, 2, w2, 2).mean(axis=(1, 3))

    L, R = half(img_l), half(img_r)
    hh, wh = L.shape
    box = [1.0] * (2 * radius + 1)
    cost = np.empty((d_max, hh, wh))
    for d in range(d_max):
        cols = np.clip(np.arange(wh) - d, 0, wh - 1)
        cost[d] = np_sep_filter(np.abs(L - R[:, cols]), box, box)
    best = np.argmin(cost, axis=0)
    c_best = np.take_along_axis(cost, best[None], 0)[0]
    cm = np.take_along_axis(cost, np.clip(best - 1, 0, d_max - 1)[None], 0)[0]
    cp = np.take_along_axis(cost, np.clip(best + 1, 0, d_max - 1)[None], 0)[0]
    denom = cm + cp - 2.0 * c_best
    delta = np.where(denom > 1e-3,
                     0.5 * (cm - cp) / np.maximum(denom, 1e-3), 0.0)
    disp = best + np.clip(delta, -0.5, 0.5)
    mean = np_sep_filter(L, [1 / len(box)] * len(box), [1 / len(box)] * len(box))
    texture = np_sep_filter(np.abs(L - mean), box, box)
    far = np.abs(np.arange(d_max)[:, None, None] - best[None]) > 2
    c_second = np.where(far, cost, np.inf).min(axis=0)
    valid = ((texture > 4.0 * len(box) ** 2) & (c_second > 1.05 * c_best + 1e-3)
             & (best > 0) & (best < d_max - 1))
    return 2.0 * disp, valid


def np_popcount_matrix(a, b):
    """(Na, Nb) Hamming distances of packed (·, 8) uint32 descriptors by a
    per-byte bit-count table."""
    table = np.array([bin(i).count("1") for i in range(256)], np.int32)
    a8 = np.ascontiguousarray(a, np.uint32).view(np.uint8)      # (Na, 32)
    b8 = np.ascontiguousarray(b, np.uint32).view(np.uint8)
    out = np.empty((a.shape[0], b.shape[0]), np.int32)
    for i0 in range(0, a.shape[0], 64):
        x = a8[i0:i0 + 64, None, :] ^ b8[None, :, :]
        out[i0:i0 + 64] = table[x].sum(-1)
    return out


def np_pm1(desc):
    """(N, 8) uint32 → (N, 256) ±1 float64, bit k of word j at 32·j + k."""
    bits = (np.asarray(desc, np.uint64)[:, :, None]
            >> np.arange(32, dtype=np.uint64)) & 1
    return bits.reshape(len(desc), 256).astype(np.float64) * 2.0 - 1.0


def np_quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([aw * bw - ax * bx - ay * by - az * bz,
                     aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw])


def np_quat_to_matrix(q):
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def np_quat_exp(phi):
    th = np.linalg.norm(phi)
    if th < 1e-12:
        return np.array([1.0, *(0.5 * phi)])
    return np.array([np.cos(th / 2), *(np.sin(th / 2) / th * phi)])


def np_madgwick_chain(q0, G, a_unit, c):
    """Float64 sequential attitude chain: q ← normalize((q⊗G_k) ⊗
    exp(c_k · a_k × ĝ)), ĝ the world z axis seen in the propagated frame."""
    q, out = np.asarray(q0, np.float64), []
    for g, a, ck in zip(np.asarray(G, np.float64), np.asarray(a_unit, np.float64),
                        np.asarray(c, np.float64)):
        qp = np_quat_mul(q, g)
        g_pred = np_quat_to_matrix(qp).T @ np.array([0.0, 0.0, 1.0])
        q = np_quat_mul(qp, np_quat_exp(np.cross(a, g_pred) * ck))
        q = q / np.linalg.norm(q)
        out.append(q)
    return np.asarray(out)


def _np_se3_exp_left(xi, R, t):
    """exp(xi) ∘ (R, t) for twists xi = [rho, phi], float64."""
    rho, phi = xi[:3], xi[3:]
    th = np.linalg.norm(phi)
    K = np.array([[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]],
                  [-phi[1], phi[0], 0]])
    if th < 1e-12:
        Rx, V = np.eye(3) + K, np.eye(3) + 0.5 * K
    else:
        Rx = np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th ** 2 * K @ K
        V = (np.eye(3) + (1 - np.cos(th)) / th ** 2 * K
             + (th - np.sin(th)) / th ** 3 * K @ K)
    return Rx @ R, Rx @ t + V @ rho


class _NpWindow:
    """Float64 stereo bundle-adjustment problem in normal-equation form:
    residuals, finite-difference Jacobians, Huber weights and the damped
    LM step of window_ba (Schur elimination is just a way to solve the
    same damped system)."""

    def __init__(self, cam, R, t, pw, obs_uv, obs_ur, ur_valid, w_mask,
                 fixed, delta):
        self.f = [float(cam.fx), float(cam.fy), float(cam.cx),
                  float(cam.cy), float(cam.baseline)]
        self.R, self.t, self.pw = R, t, pw
        self.obs_uv, self.obs_ur = obs_uv, obs_ur
        self.ur_valid, self.w_mask = ur_valid, w_mask
        self.fixed, self.delta = fixed, delta

    def residuals(self, R, t, pw):
        fx, fy, cx, cy, b = self.f
        pc = np.einsum("wab,lb->wla", R, pw) + t[:, None, :]
        z = pc[..., 2]
        u = fx * pc[..., 0] / z + cx
        v = fy * pc[..., 1] / z + cy
        ur = u - fx * b / z
        return np.stack([u - self.obs_uv[..., 0], v - self.obs_uv[..., 1],
                         np.where(self.ur_valid, ur - self.obs_ur, 0.0)], -1)

    def cost(self, R, t, pw, w_mask=None):
        w_mask = self.w_mask if w_mask is None else w_mask
        rn = np.linalg.norm(self.residuals(R, t, pw), axis=-1)
        d = self.delta
        rho = np.where(rn <= d, 0.5 * rn ** 2, d * (rn - 0.5 * d))
        return float(np.sum(np.where(w_mask, rho, 0.0)))

    def step(self, R, t, pw, lam, w_mask=None):
        """One damped LM step; returns (R', t', pw')."""
        w_mask = self.w_mask if w_mask is None else w_mask
        W, L = w_mask.shape
        r = self.residuals(R, t, pw)                         # (W, L, 3)
        eps = 1e-6
        Jp = np.zeros((W, L, 3, 6))
        for k in range(6):
            xi = np.zeros(6)
            xi[k] = eps
            rp = self.residuals(*map(np.stack, zip(*[
                _np_se3_exp_left(xi, R[w], t[w]) for w in range(W)])), pw)
            rm = self.residuals(*map(np.stack, zip(*[
                _np_se3_exp_left(-xi, R[w], t[w]) for w in range(W)])), pw)
            Jp[..., k] = (rp - rm) / (2 * eps)
        Jl = np.zeros((W, L, 3, 3))
        for k in range(3):
            dp = np.zeros(3)
            dp[k] = eps
            Jl[..., k] = (self.residuals(R, t, pw + dp)
                          - self.residuals(R, t, pw - dp)) / (2 * eps)
        rn = np.linalg.norm(r, axis=-1)
        wgt = np.where(w_mask, np.where(rn <= self.delta, 1.0,
                                        self.delta / np.maximum(rn, 1e-12)), 0.0)
        Jp[self.fixed] = 0.0
        Hpp = np.einsum("wlak,wl,wlam->wkm", Jp, wgt, Jp)
        Hpl = np.einsum("wlak,wl,wlab->wlkb", Jp, wgt, Jl)
        Hll = np.einsum("wlab,wl,wlac->lbc", Jl, wgt, Jl)
        bp = -np.einsum("wlak,wl,wla->wk", Jp, wgt, r)
        bl = -np.einsum("wlab,wl,wla->lb", Jl, wgt, r)
        tr_l = np.trace(Hll, axis1=1, axis2=2)
        Hll = Hll + (lam * np.maximum(tr_l / 3, 1e-6) + 1e-8)[:, None, None] * np.eye(3)
        tr_p = np.trace(Hpp, axis1=1, axis2=2)
        Hpp = Hpp + (lam * np.maximum(tr_p / 6, 1e-6))[:, None, None] * np.eye(6)
        free = np.flatnonzero(~self.fixed)
        nP, nL = 6 * len(free), 3 * L
        H = np.zeros((nP + nL, nP + nL))
        g = np.zeros(nP + nL)
        for a, w in enumerate(free):
            H[6 * a:6 * a + 6, 6 * a:6 * a + 6] = Hpp[w]
            blk = Hpl[w].transpose(1, 0, 2).reshape(6, nL)
            H[6 * a:6 * a + 6, nP:] = blk
            H[nP:, 6 * a:6 * a + 6] = blk.T
            g[6 * a:6 * a + 6] = bp[w]
        for l in range(L):
            H[nP + 3 * l:nP + 3 * l + 3, nP + 3 * l:nP + 3 * l + 3] = Hll[l]
        g[nP:] = bl.reshape(-1)
        dx = np.linalg.solve(H, g)
        R2, t2 = R.copy(), t.copy()
        for a, w in enumerate(free):
            R2[w], t2[w] = _np_se3_exp_left(dx[6 * a:6 * a + 6], R[w], t[w])
        return R2, t2, pw + dx[nP:].reshape(L, 3)

    def lm(self, R, t, pw, iters, w_mask=None):
        """window_ba's LM loop: accept on cost decrease, λ ×0.3 / ×5, stop
        after an accepted step that improves the cost by < 1e-5 relative."""
        lam, cost = 1e-4, self.cost(R, t, pw, w_mask)
        for _ in range(iters):
            R2, t2, pw2 = self.step(R, t, pw, lam, w_mask)
            c2 = self.cost(R2, t2, pw2, w_mask)
            if c2 < cost:
                done = cost - c2 < 1e-5 * cost
                R, t, pw, cost = R2, t2, pw2, c2
                lam = max(lam * 0.3, 1e-7)
                if done:
                    break
            else:
                lam = min(lam * 5.0, 1e3)
        return R, t, pw


# -------------------------------------------------------------------- checks
def _summary(name, err, tol, why):
    return f"{name}: max err {err:.3g} (tol {tol:.3g}; {why})"


def check_gather_blocks(seed: int = 0):
    """_gather_blocks at both callers' shapes: LK's (3, H+24, W+24)
    img/gx/gy stack with 256 22×22 blocks and its 256 39×39 search windows,
    and ORB's 1000 27×27 blocks.  A gather moves values: exact."""
    from ..ops import image as imops

    rng = np.random.default_rng(seed)
    cases = [((3, HEIGHT + 24, WIDTH + 24), 256, 22),
             ((HEIGHT + 78, WIDTH + 78), 256, 39),
             ((HEIGHT + 28, WIDTH + 28), 1000, 27)]
    for shape, n, size in cases:
        padded = rng.uniform(0, 255, shape).astype(np.float32)
        hp, wp = shape[-2:]
        cx = rng.integers(0, wp - size + 1, n).astype(np.int32)
        cy = rng.integers(0, hp - size + 1, n).astype(np.int32)
        cx[:2], cy[:2] = (0, wp - size), (0, hp - size)     # both corners
        got = np.asarray(imops._gather_blocks(
            jnp.asarray(padded), jnp.asarray(cx), jnp.asarray(cy), size))
        ref = np.stack([padded[..., y:y + size, x:x + size]
                        for x, y in zip(cx, cy)])
        assert got.shape == ref.shape, (got.shape, ref.shape)
        assert np.array_equal(got, ref), f"gather {shape}x{size} differs"
    return _summary("gather_blocks", 0.0, 0.0, "a gather is exact")


def check_grad_pyramid(seed: int = 0):
    """build_grad_pyramid on the tracker's (3, 480, 752) stack, 3 levels,
    against float64 Scharr + pyrDown."""
    from ..ops import image as imops

    left, right = stereo_frame(seed)
    stack = np.stack([left, right, np.roll(left, 5, axis=1)])
    got = imops.build_grad_pyramid(jnp.asarray(stack), 3)
    ref = np_grad_pyramid(stack, 3)
    # float32 sums of ≤ 30 taps over values ≤ 255: a few ulp(255) ≈ 1e-5.
    tol, err = 1e-3, 0.0
    for g_lvl, r_lvl in zip(got, ref):
        for g, r in zip(g_lvl, r_lvl):
            assert g.shape == r.shape, (g.shape, r.shape)
            err = max(err, float(np.max(np.abs(np.asarray(g, np.float64) - r))))
    assert err <= tol, err
    return _summary("grad_pyramid", err, tol, "float32 rounding of tap sums")


def check_equalize_hist(seed: int = 0):
    """equalize_hist on the stereo pair against np.bincount and an integer
    rounded LUT: exact (one-hot and integer arithmetic)."""
    from ..ops import image as imops

    pair = np.stack(stereo_frame(seed))
    got = np.asarray(imops.equalize_hist(jnp.asarray(pair)))
    idx = np.clip(pair, 0, 255).astype(np.int64)
    ref = np.empty_like(pair)
    for i in range(len(pair)):
        cdf = np.cumsum(np.bincount(idx[i].ravel(), minlength=256))
        cdf_min = cdf[np.argmax(cdf > 0)]
        denom = max(cdf[-1] - cdf_min, 1)
        lut = np.clip(np.floor((cdf - cdf_min) * 255 / denom + 0.5), 0, 255)
        ref[i] = lut[idx[i]]
    err = float(np.max(np.abs(got - ref)))
    assert err == 0.0, err
    return _summary("equalize_hist", err, 0.0, "integer counts and LUT")


def check_fast_nms(seed: int = 0):
    """FAST-9 + 3×3 NMS + margin at 752×480 on a uint8-valued frame against
    a numpy FAST-9: integer-valued arithmetic, so exact."""
    from ..ops import orb

    img, _ = stereo_frame(seed)
    got = np.asarray(orb.fast_score_nms(jnp.asarray(img), 20.0))
    ref = np_fast_nms(img, 20.0)
    err = float(np.max(np.abs(got - ref)))
    assert err == 0.0, err
    assert np.count_nonzero(ref) > 1000, "too few corners to test top-k"
    return _summary("fast_nms", err, 0.0, "integer-valued scores")


def check_topk(seed: int = 0):
    """detect_and_compute's exact top-1000 against a numpy sort of the
    reference FAST scores.  Ties may be broken either way, so the check is
    on the selected score multiset and on the threshold it implies."""
    from ..ops import orb

    img, _ = stereo_frame(seed)
    k = 1000
    uv, desc, valid, ang = orb.detect_and_compute(jnp.asarray(img),
                                                  num_features=k)
    uv = np.asarray(uv).astype(np.int64)
    ref = np_fast_nms(img, 20.0)
    picked = ref[uv[:, 1], uv[:, 0]]
    want = np.sort(ref.ravel())[::-1][:k]
    assert len({(x, y) for x, y in uv}) == k, "duplicate keypoints"
    assert np.array_equal(np.sort(picked)[::-1], want), "top-k scores differ"
    assert np.all(np.diff(picked) <= 0), "keypoints not in score order"
    assert np.array_equal(np.asarray(valid), picked > 0)
    assert np.asarray(desc).shape == (k, 8) and np.isfinite(np.asarray(ang)).all()
    return _summary("top_k", 0.0, 0.0, "same score multiset as a full sort")


def check_disparity_sweep(seed: int = 0):
    """disparity_sweep on a 752×480 pair against brute-force float64 SAD.
    The device cost volume is bf16 (bandwidth), which rounds box sums by
    up to ~0.4 %: near-tied winners and validity margins may flip on a few
    pixels, and subpixel offsets move by a few hundredths."""
    from ..ops import stereo

    left, right = stereo_frame(seed)
    d, v = stereo.disparity_sweep(jnp.asarray(left), jnp.asarray(right))
    d, v = np.asarray(d), np.asarray(v)
    rd, rv = np_disparity(left, right)
    agree = float(np.mean(v == rv))
    both = v & rv
    err = np.abs(d - rd)[both]
    frac_close = float(np.mean(err <= 0.25))
    med = float(np.median(err))
    assert rv.mean() > 0.5, "reference found too few valid pixels"
    assert agree >= 0.98, f"validity agreement {agree:.4f}"
    assert frac_close >= 0.98, f"within 0.25 px: {frac_close:.4f}"
    assert med <= 0.05, med
    return (f"disparity_sweep: validity agree {agree:.4f} (tol 0.98), "
            f"{frac_close:.4f} within 0.25 px (tol 0.98), median err "
            f"{med:.3g} px (tol 0.05; bf16 cost volume)")


def check_hamming(seed: int = 0):
    """hamming_matrix against numpy bit counts at the loop node's
    1000 × 4096 and at sizes that are not multiples of 128: exact."""
    from ..ops import orb

    rng = np.random.default_rng(seed)
    for na, nb in ((1000, 4096), (300, 129), (37, 1000)):
        a = rng.integers(0, 2 ** 32, (na, 8), dtype=np.uint32)
        b = rng.integers(0, 2 ** 32, (nb, 8), dtype=np.uint32)
        got = np.asarray(orb.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
        assert np.array_equal(got, np_popcount_matrix(a, b)), (na, nb)
    return _summary("hamming_matrix", 0.0, 0.0, "integer popcounts")


def check_bow_transform(seed: int = 0):
    """bow.transform (1000 descriptors, 4096 words) against float64 numpy.
    ±1 similarities are exact at any matmul precision (TF32 included), so
    word assignment is exact; only the tf-idf L1 normalisation rounds."""
    from ..loop import bow

    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2 ** 32, (4096, 8), dtype=np.uint32)
    desc = rng.integers(0, 2 ** 32, (1000, 8), dtype=np.uint32)
    desc[:200] = words[rng.integers(0, 4096, 200)]            # exact hits
    valid = rng.uniform(size=1000) < 0.9
    idf = rng.uniform(0.1, 5.0, 4096).astype(np.float32)
    vocab = bow.Vocabulary(jnp.asarray(np_pm1(words), jnp.float32),
                           jnp.asarray(idf))
    got = np.asarray(bow.transform(vocab, jnp.asarray(desc), jnp.asarray(valid)))
    assign = np.argmax(np_pm1(desc) @ np_pm1(words).T, axis=1)
    tf = np.bincount(assign[valid], minlength=4096).astype(np.float64)
    ref = tf * idf
    ref /= np.abs(ref).sum()
    err = float(np.max(np.abs(got - ref)))
    tol = 1e-6
    assert err <= tol, err
    return _summary("bow_transform", err, tol, "float32 L1 normalisation")


def _window_problem(seed: int = 0):
    """A full window (10 keyframes × 600 landmarks, all observed in stereo)
    with 0.3 px pixel noise, 3 % gross outliers, perturbed poses and 5 cm
    landmark noise.  Returns (cfg, cam, WindowState, _NpWindow)."""
    from ..backend import window_ba
    from ..config import BackendConfig
    from ..geometry import camera, se3, so3

    rng = np.random.default_rng(seed)
    cfg = BackendConfig(max_landmarks=600)
    cam = camera.make(458.0, 458.0, 376.0, 240.0, 0.11, width=WIDTH,
                      height=HEIGHT)
    W, L = cfg.window_size, cfg.max_landmarks
    pts = rng.uniform([-4, -3, 4], [4, 3, 14], (L, 3))
    st = window_ba.empty(cfg)
    for i in range(W):
        q = so3.exp(jnp.asarray([0.01 * i, 0.02 * i, 0.0]))
        C = np.array([0.1 * i, 0.02 * i, 0.0])
        Rm = np.asarray(so3.to_matrix(q), np.float64)
        t = -Rm @ C
        pc = pts @ Rm.T + t
        uvr = np.stack([458.0 * pc[:, 0] / pc[:, 2] + 376.0,
                        458.0 * pc[:, 1] / pc[:, 2] + 240.0,
                        458.0 * (pc[:, 0] - 0.11) / pc[:, 2] + 376.0], -1)
        uvr += rng.normal(0, 0.3, uvr.shape)
        out = rng.uniform(size=L) < 0.03
        uvr[out] += rng.normal(0, 20.0, (out.sum(), 3))
        xi = np.zeros(6) if i == 0 else np.concatenate(
            [rng.normal(0, 0.01, 3), rng.normal(0, 0.002, 3)])
        T = se3.retract_left(se3.SE3(q, jnp.asarray(t, jnp.float32)),
                             jnp.asarray(xi, jnp.float32))
        pkt = window_ba.KeyframePacket(
            frame_id=jnp.asarray(i, jnp.int32), q=T.q, t=T.t,
            lm_id=jnp.arange(100, 100 + L, dtype=jnp.int32),
            lm_uv=jnp.asarray(uvr[:, :2], jnp.float32),
            lm_ur=jnp.asarray(uvr[:, 2], jnp.float32),
            lm_ur_mask=jnp.ones(L, bool),
            lm_pw=jnp.asarray(pts + rng.normal(0, 0.05, pts.shape), jnp.float32),
            lm_mask=jnp.ones(L, bool))
        st = window_ba.add_keyframe(cfg, st, pkt)
    w_mask = np.asarray(st.obs_valid & st.kf_valid[:, None] & st.lm_valid[None, :])
    fid = np.where(np.asarray(st.kf_valid), np.asarray(st.kf_frame_id), 2 ** 31 - 1)
    fixed = np.arange(W) == np.argmin(fid)
    R = np.stack([np_quat_to_matrix(q) for q in np.asarray(st.kf_q, np.float64)])
    prob = _NpWindow(cam, R, np.asarray(st.kf_t, np.float64),
                     np.asarray(st.lm_pw, np.float64),
                     np.asarray(st.obs_uv, np.float64),
                     np.asarray(st.obs_ur, np.float64),
                     np.asarray(st.obs_ur_valid) & w_mask, w_mask, fixed,
                     cfg.huber_delta)
    return cfg, cam, st, prob


def _pose_errors(q, t, R_ref, t_ref):
    R = np.stack([np_quat_to_matrix(x) for x in np.asarray(q, np.float64)])
    rot = max(float(np.linalg.norm(R[w] - R_ref[w])) for w in range(len(R)))
    return rot, float(np.max(np.abs(np.asarray(t, np.float64) - t_ref)))


def check_window_ba_step(seed: int = 0):
    """One damped Schur LM step of window_ba (λ = 1e-4) against the float64
    dense normal-equation step.  float32 assembly and solve of a system
    with condition ~1e6 leave ≲ 1e-4 relative error in the step."""
    from ..backend import window_ba

    cfg, cam, st, prob = _window_problem(seed)
    w_mask = jnp.asarray(prob.w_mask)
    obs = (st.obs_uv, st.obs_ur, st.obs_ur_valid & w_mask)
    poses, lm = jax.jit(
        window_ba._schur_step, static_argnames=("delta",))(
        cam, st.poses(), st.lm_pw, obs, w_mask, jnp.asarray(prob.fixed),
        jnp.asarray(1e-4, jnp.float32), delta=cfg.huber_delta)
    R2, t2, pw2 = prob.step(prob.R, prob.t, prob.pw, 1e-4)
    step_t = float(np.max(np.abs(t2 - prob.t)))
    step_l = float(np.max(np.abs(pw2 - prob.pw)))
    rot, dt = _pose_errors(poses.q, poses.t, R2, t2)
    dl = float(np.max(np.abs(np.asarray(lm, np.float64) - pw2)))
    rel = max(dt / step_t, dl / step_l)
    tol = 1e-2
    assert rel <= tol and rot <= 1e-4, (rel, rot)
    return _summary("window_ba_step", rel, tol,
                    "relative to the step; float32 normal equations")


def check_window_ba_optimize(seed: int = 0):
    """window_ba.optimize (12 + cull + 8 LM iterations) against the same
    schedule run in float64 numpy: both converge to the same minimum, so
    poses agree to ≲ 1 mm and landmarks to a few mm (float32 state)."""
    from ..backend import window_ba

    cfg, cam, st, prob = _window_problem(seed)
    res = window_ba.optimize(cfg, cam, st)
    R1, t1, pw1 = prob.lm(prob.R, prob.t, prob.pw, cfg.iters1)
    chi2 = np.sum(prob.residuals(R1, t1, pw1) ** 2, axis=-1)
    mask2 = prob.w_mask & (chi2 < cfg.chi2_cull)
    prob.ur_valid = prob.ur_valid & mask2
    R2, t2, pw2 = prob.lm(R1, t1, pw1, cfg.iters2, mask2)
    out = res.state
    rot, dt = _pose_errors(out.kf_q, out.kf_t, R2, t2)
    dl = float(np.median(np.linalg.norm(np.asarray(out.lm_pw, np.float64) - pw2,
                                        axis=-1)))
    assert np.isfinite(float(res.cost)) and bool(res.correction.valid)
    assert dt <= 1e-3 and rot <= 1e-3 and dl <= 5e-3, (dt, rot, dl)
    return (f"window_ba_optimize: pose err {dt:.3g} m (tol 1e-3), rot "
            f"{rot:.3g} (tol 1e-3), median landmark err {dl:.3g} m "
            f"(tol 5e-3; float32 state at the same minimum)")


def check_attitude_chain(seed: int = 0):
    """vimotion.attitude_chain over a 16-sample packet against the float64
    Madgwick loop: float32 rounding over 16 renormalised steps."""
    from ..vio import vimotion

    rng = np.random.default_rng(seed)
    P = 16
    q0 = rng.normal(size=4)
    q0 /= np.linalg.norm(q0)
    G = np.stack([np_quat_exp(rng.normal(0, 0.05, 3)) for _ in range(P)])
    a = rng.normal([0, 0, 1], 0.2, (P, 3))
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    c = rng.uniform(0, 0.025, P)
    got = np.asarray(vimotion.attitude_chain(
        *(jnp.asarray(x, jnp.float32) for x in (q0, G, a, c))))
    ref = np_madgwick_chain(q0, G, a, c)
    err = float(np.max(np.abs(got - ref)))
    tol = 1e-5
    assert err <= tol, err
    return _summary("attitude_chain", err, tol, "float32 over 16 steps")


CHECKS = {
    "gather_blocks": check_gather_blocks,
    "grad_pyramid": check_grad_pyramid,
    "equalize_hist": check_equalize_hist,
    "fast_nms": check_fast_nms,
    "top_k": check_topk,
    "disparity_sweep": check_disparity_sweep,
    "hamming_matrix": check_hamming,
    "bow_transform": check_bow_transform,
    "window_ba_step": check_window_ba_step,
    "window_ba_optimize": check_window_ba_optimize,
    "attitude_chain": check_attitude_chain,
}


# ------------------------------------------------------ device vs the CPU
def check_scan_vs_cpu(frames: int = 8):
    """One `frames`-frame track_frames_scan chunk on the default device and
    on the CPU in the same process.  Catches TF32 and reduction-order drift
    in the frontend: poses agree to 1 mm / 1e-3, and landmark depths that
    both runs hold agree to 1 % on ≥ 95 % of the slots."""
    from ..config import bench_frontend_config
    from ..frontend import tracker
    from ..geometry import camera, so3
    from ..io.synthetic import PlanarScene, SceneConfig, orbit_trajectory

    cfg = bench_frontend_config()
    scfg = SceneConfig(width=WIDTH, height=HEIGHT, fx=458.0, fy=458.0,
                       cx=376.0, cy=240.0, baseline=0.11)
    cam = camera.make(458.0, 458.0, 376.0, 240.0, 0.11, width=WIDTH,
                      height=HEIGHT)
    scene = PlanarScene(scfg, plane_depth=8.0, seed=0)
    rendered = [scene.render(R, t) for R, t in orbit_trajectory(frames, step=0.02)]
    u8 = lambda a: np.clip(np.round(a), 0, 255).astype(np.uint8)
    i0 = np.stack([u8(f[0]) for f in rendered])
    i1 = np.stack([u8(f[1]) for f in rendered])

    def run(device):
        with jax.default_device(device):
            st, out = tracker.track_frames_scan(
                cfg, cam, tracker.init_state(cfg), jnp.asarray(i0),
                jnp.asarray(i1))
            R = so3.to_matrix(st.T_c_w.q)
            z = jnp.einsum("ab,nb->na", R, st.table.p_w,
                           precision="highest")[:, 2] + st.T_c_w.t[2]
            return jax.device_get((out.status, out.T_c_w.q, out.T_c_w.t,
                                   st.table.has_3d & st.table.active, z))

    dev = run(jax.devices()[0])
    cpu = run(jax.devices("cpu")[0])
    assert np.all(dev[0] == 1) and np.all(cpu[0] == 1), "not all TRACKING"
    dq = float(np.max(np.abs(np.abs(np.sum(dev[1] * cpu[1], -1)) - 1.0)))
    dt = float(np.max(np.abs(dev[2] - cpu[2])))
    both = dev[3] & cpu[3]
    rel = np.abs(dev[4] - cpu[4])[both] / np.abs(cpu[4][both])
    close = float(np.mean(rel <= 1e-2))
    assert both.sum() >= 100, int(both.sum())
    assert dt <= 1e-3 and dq <= 1e-3, (dt, dq)
    assert close >= 0.95, close
    return (f"scan_vs_cpu ({frames} frames): pose err {dt:.3g} m (tol 1e-3), "
            f"|1-<q,q'>| {dq:.3g} (tol 1e-3), {close:.4f} of {int(both.sum())} "
            f"shared depths within 1 % (tol 0.95)")
