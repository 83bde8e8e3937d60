"""Loop closing: place recognition, geometric verification, PGO, drift.

Array-native re-design of the reference's LoopClosingNodeletClass
(/root/reference/src/backend/vo_loopclosing.cpp:114-1130), whose two worker
threads do: (A) ingest keyframes — ORB detectAndCompute, DBoW3 transform,
depth recovery for the ORB points (243-351); (B) search + optimize — BoW
similarity row against all keyframes (421-436), temporal + neighbour-
consistency candidate gating (isLoopCandidate, 520-589), mutual-kNN +
ratio-test matching and PnP-RANSAC verification with translation/rotation
accept gates (isLoopClosureKF, 591-729), then pose-graph optimization over
the covisibility chain and accumulation of the map→odom drift transform
(loopClosureOnCovGraphG2ONew, 742-944).

Here each stage is a fixed-shape jitted program (ops.orb, loop.bow,
ops.pnp, loop.pose_graph); this class is the thin host-side orchestrator.
The keyframe database is fixed-capacity device arrays; similarity against
the entire database is one matvec instead of the reference's O(N) loop.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import LoopConfig
from ..geometry import camera as cam_m, se3 as se3m, so3
from ..geometry.camera import StereoCamera
from ..geometry.se3 import SE3
from ..ops import image as imops, orb, pnp, stereo
from . import bow, pose_graph


import functools


@functools.partial(jax.jit, donate_argnums=0)
def _db_set_row(db, k, row):
    """In-place device row update: donation lets XLA alias the (K, V)
    database buffer instead of copying ~32 MB per keyframe insert."""
    return db.at[k].set(row)


def _ingest_body(img_l, img_r, cam: StereoCamera, num_features: int,
                 depth_mode: bool):
    """Thread-A ingest for ONE keyframe: ORB detect+compute plus keypoint
    depth — the reference runs these as successive host calls
    (vo_loopclosing.cpp:243-351).  Shared by the stepwise `_ingest` program
    and the whole-chunk `_ingest_rows` scan.

    Keypoint depth: a dense half-res plane-sweep disparity map sampled at
    the keypoints (ops/stereo.py) — the reference LK-tracks its 1000 ORB
    points left→right (vo_loopclosing.cpp:262-283), but per-point iterative
    LK at this count re-gathers 1000 patches per GN iteration, while the
    sweep's cost is independent of the keypoint count.
    In depth mode img_r is an aligned depth image (Z16 / depth_factor) and
    the lookup replaces the sweep.  Returns (uv, desc, kp_valid, p_c,
    pc_valid)."""
    # uint8 frames widen on device (see tracker.track_frame — the chunk
    # image stacks are shipped uint8 to quarter the host-link transfer).
    if img_l.dtype != jnp.float32:
        img_l = img_l.astype(jnp.float32)
    if not depth_mode and img_r.dtype != jnp.float32:
        img_r = img_r.astype(jnp.float32)
    uv, desc, kp_valid, _ = orb.detect_and_compute(
        img_l, num_features=num_features)
    if depth_mode:
        z = imops.bilinear_sample(img_r, uv) / cam.depth_factor
        d_ok = (z > 0.1) & (z < 100.0)
    else:
        disp_map, dv = stereo.disparity_sweep(img_l, img_r)
        disp, d_ok = stereo.keypoint_disparity(disp_map, dv, uv)
        z = cam.fx * cam.baseline / jnp.maximum(disp, 1e-3)
        d_ok = d_ok & (z > 0.1) & (z < 100.0)
    p_c = cam_m.backproject(cam, uv, z)
    return uv, desc, kp_valid, p_c, d_ok & kp_valid


@functools.partial(jax.jit, static_argnames=("num_features", "depth_mode"))
def _ingest(img_l, img_r, cam: StereoCamera, num_features: int,
            depth_mode: bool):
    """Single-keyframe fused ingest program (stepwise path)."""
    return _ingest_body(img_l, img_r, cam, num_features, depth_mode)


@functools.partial(
    jax.jit, static_argnames=("num_features", "depth_mode"),
    donate_argnums=(0, 1, 2, 3, 4, 5, 6, 7, 8))
def _ingest_rows(uv_s, desc_s, kpv_s, pc_s, pcv_s,
                 q_odom_s, t_odom_s, q_s, t_s,
                 imgs_l, imgs_r, sel, rows, row_valid,
                 Tcw_q, Tcw_t, Tmo_q, Tmo_t, cam: StereoCamera,
                 num_features: int, depth_mode: bool):
    """Vocabulary-less variant of the block ingest program (see
    _ingest_rows_body; the steady path uses the BoW-fused
    _ingest_rows_bow)."""
    return _ingest_rows_body(
        uv_s, desc_s, kpv_s, pc_s, pcv_s, q_odom_s, t_odom_s, q_s, t_s,
        imgs_l, imgs_r, sel, rows, row_valid, Tcw_q, Tcw_t, Tmo_q, Tmo_t,
        cam, num_features, depth_mode)


def _ingest_rows_body(uv_s, desc_s, kpv_s, pc_s, pcv_s,
                      q_odom_s, t_odom_s, q_s, t_s,
                      imgs_l, imgs_r, sel, rows, row_valid,
                      Tcw_q, Tcw_t, Tmo_q, Tmo_t, cam: StereoCamera,
                      num_features: int, depth_mode: bool):
    """Whole-chunk keyframe ingest as ONE device program: gather the chunk's
    keyframe images from the (T, H, W) stacks, run the per-keyframe ORB +
    depth ingest under a lax.scan (bounds the pyramid/descriptor working
    set to one frame), scatter every store row in one batched write, and
    insert the batch's odometry + drift-corrected node poses.

    The reference's ingest runs on a free-running thread that never blocks
    tracking (vo_loopclosing.cpp:181-392); a per-keyframe host loop would
    cost ~5 device dispatches and host round trips per keyframe instead of
    one program per chunk.  `rows` are the destination store rows;
    `row_valid` masks bucket padding (invalid rows scatter out of bounds
    and are dropped).  Returns the updated stores plus the batch's stacked
    (desc, kp_valid) for BoW transform / vocabulary training.

    Structure: lax.scan over blocks of 8 vmapped ingests — the per-image
    ingest is a chain of small/medium ops (FAST grid, descriptor gathers,
    the stereo-LK GN iterations) whose cost is per-op latency, not FLOPs;
    vmapping 8 images through each op amortizes that latency ~8× while
    bounding the pyramid working set to 8 frames (a full vmap over a
    64-keyframe chunk would hold ~50 MB × 8 of pyramids live)."""
    K = uv_s.shape[0]
    B = 8 if sel.shape[0] % 8 == 0 else sel.shape[0]   # 4-wide remainder
    sel_b = sel.reshape(-1, B)

    def one(_, sb):
        outs = jax.vmap(
            lambda il, ir: _ingest_body(il, ir, cam, num_features,
                                        depth_mode))(imgs_l[sb], imgs_r[sb])
        return None, outs

    _, outs = jax.lax.scan(one, None, sel_b)
    uv, desc, kpv, pc, pcv = jax.tree.map(
        lambda a: a.reshape((sel.shape[0],) + a.shape[2:]), outs)
    tgt = jnp.where(row_valid, rows, K)          # OOB rows dropped
    uv_s = uv_s.at[tgt].set(uv, mode="drop")
    desc_s = desc_s.at[tgt].set(desc, mode="drop")
    kpv_s = kpv_s.at[tgt].set(kpv, mode="drop")
    pc_s = pc_s.at[tgt].set(pc, mode="drop")
    pcv_s = pcv_s.at[tgt].set(pcv, mode="drop")
    T_wc = se3m.inverse(SE3(Tcw_q, Tcw_t))       # batched (M, ·)
    T_node = se3m.compose(SE3(Tmo_q, Tmo_t), T_wc)
    q_odom_s = q_odom_s.at[tgt].set(T_wc.q, mode="drop")
    t_odom_s = t_odom_s.at[tgt].set(T_wc.t, mode="drop")
    q_s = q_s.at[tgt].set(T_node.q, mode="drop")
    t_s = t_s.at[tgt].set(T_node.t, mode="drop")
    return (uv_s, desc_s, kpv_s, pc_s, pcv_s,
            q_odom_s, t_odom_s, q_s, t_s, desc, kpv)


@functools.partial(
    jax.jit, static_argnames=("num_features", "depth_mode"),
    donate_argnums=(0, 1, 2, 3, 4, 5, 6, 7, 8, 9))
def _ingest_rows_bow(db, uv_s, desc_s, kpv_s, pc_s, pcv_s,
                     q_odom_s, t_odom_s, q_s, t_s,
                     words_pm1, idf,
                     imgs_l, imgs_r, sel, rows, row_valid,
                     Tcw_q, Tcw_t, Tmo_q, Tmo_t, cam: StereoCamera,
                     num_features: int, depth_mode: bool):
    """_ingest_rows with the BoW transform + database scatter FUSED in (the
    vocabulary-present steady path): one fused program per 8-keyframe
    block instead of ingest+BoW halves the loop node's per-chunk program
    count."""
    (uv_s, desc_s, kpv_s, pc_s, pcv_s, q_odom_s, t_odom_s, q_s, t_s,
     desc, kpv) = _ingest_rows_body(
        uv_s, desc_s, kpv_s, pc_s, pcv_s, q_odom_s, t_odom_s, q_s, t_s,
        imgs_l, imgs_r, sel, rows, row_valid, Tcw_q, Tcw_t, Tmo_q, Tmo_t,
        cam, num_features, depth_mode)
    vocab = bow.Vocabulary(words_pm1, idf)

    def one(_, i):
        return None, bow.transform(vocab, desc[i], kpv[i])

    _, bows = jax.lax.scan(one, None, jnp.arange(desc.shape[0]))
    tgt = jnp.where(row_valid, rows, db.shape[0])
    db = db.at[tgt].set(bows, mode="drop")
    return (db, uv_s, desc_s, kpv_s, pc_s, pcv_s,
            q_odom_s, t_odom_s, q_s, t_s, desc, kpv)


@jax.jit
def _gather_frames(imgs, sel):
    """Keyframe-image gather on the FRONTEND chip — in two-chip mode only
    the (Mp, H, W) gathered stacks cross to the loop chip, not the whole
    chunk."""
    return imgs[sel]


@functools.partial(jax.jit, donate_argnums=(0,))
def _bow_rows(db, words_pm1, idf, desc_s, kpv_s, rows, row_valid):
    """Transform stored descriptor rows → tf-idf BoW vectors and scatter
    them into the database, all in ONE device program (a lax.scan over rows
    bounds the (F, V) assignment matmul to one keyframe at a time).  Serves
    both the fresh-chunk path (rows just written by _ingest_rows) and the
    vocabulary back-fill/refresh (any stored rows)."""
    vocab = bow.Vocabulary(words_pm1, idf)

    def one(_, ri):
        return None, bow.transform(vocab, desc_s[ri], kpv_s[ri])

    _, bows = jax.lax.scan(one, None, rows)
    tgt = jnp.where(row_valid, rows, db.shape[0])
    return db.at[tgt].set(bows, mode="drop")


@functools.partial(jax.jit, donate_argnums=(0, 1, 2, 3, 4))
def _store_set_rows(uv_s, desc_s, kpv_s, pc_s, pcv_s, k,
                    uv, desc, kpv, pc, pcv):
    """Donated row writes into the device-resident keyframe feature store."""
    return (uv_s.at[k].set(uv), desc_s.at[k].set(desc), kpv_s.at[k].set(kpv),
            pc_s.at[k].set(pc), pcv_s.at[k].set(pcv))


@functools.partial(jax.jit, donate_argnums=(0, 1, 2, 3))
def _pose_set_rows(q_odom_s, t_odom_s, q_s, t_s, k, Tcw_q, Tcw_t,
                   Tmo_q, Tmo_t):
    """Insert keyframe k's odometry pose (as T_w_c) and its drift-corrected
    node pose T_map_odom ∘ T_w_c into the device pose tables."""
    T_wc = se3m.inverse(SE3(Tcw_q, Tcw_t))
    T_node = se3m.compose(SE3(Tmo_q, Tmo_t), T_wc)
    return (q_odom_s.at[k].set(T_wc.q), t_odom_s.at[k].set(T_wc.t),
            q_s.at[k].set(T_node.q), t_s.at[k].set(T_node.t))


@jax.jit
def _match_pairs(desc_s, kpv_s, pcv_s, i, j, ratio):
    """Mutual-ratio matches between stored keyframes i and j — the debug
    companion of _verify_device, fetched only when rendering an accepted
    loop's match image (vo_loopclosing.cpp:689-722)."""
    valid_i = kpv_s[i] & pcv_s[i]
    valid_j = kpv_s[j]
    return orb.mutual_ratio_match(desc_s[i], desc_s[j], valid_i, valid_j,
                                  ratio=ratio)


@functools.partial(jax.jit, static_argnames=("num_hypotheses",))
def _verify_device(desc_s, kpv_s, pcv_s, pc_s, uv_s, node_q, node_t, i, j,
                   fx, fy, cx, cy, key,
                   ratio, threshold_n, num_hypotheses: int):
    """Geometric loop verification as ONE device program over the resident
    store (isLoopClosureKF, vo_loopclosing.cpp:591-729): gather the two
    keyframes' rows, mutual-ratio match, PnP RANSAC from KF i's world points
    to KF j's normalized pixels, and compute the accept-gate statistics.

    Returns (T_ij.q, T_ij.t, n_match, n_inl, |Δt|, |Δlog R|) — six tiny
    scalars/vectors; nothing keyframe-sized crosses the host boundary."""
    desc_i, desc_j = desc_s[i], desc_s[j]
    valid_i = kpv_s[i] & pcv_s[i]
    valid_j = kpv_s[j]
    match_j, good = orb.mutual_ratio_match(
        desc_i, desc_j, valid_i, valid_j, ratio=ratio)
    T_wc_i = SE3(node_q[i], node_t[i])
    pts_w = se3m.transform_points(T_wc_i, pc_s[i])
    uv_j = uv_s[j][match_j]
    xn = jnp.stack([(uv_j[:, 0] - cx) / fx, (uv_j[:, 1] - cy) / fy], axis=-1)
    T_cj_w, _, n_inl = pnp.pnp_ransac(
        key, pts_w, xn, good, threshold_n=threshold_n,
        num_hypotheses=num_hypotheses)
    T_wc_j_meas = se3m.inverse(T_cj_w)
    delta = se3m.compose(se3m.inverse(SE3(node_q[j], node_t[j])), T_wc_j_meas)
    dt = jnp.linalg.norm(delta.t)
    dr = jnp.linalg.norm(so3.log(delta.q))
    T_ij = se3m.compose(se3m.inverse(T_wc_i), T_wc_j_meas)
    return T_ij.q, T_ij.t, jnp.sum(good), n_inl, dt, dr


@functools.partial(jax.jit, static_argnames=("num_hypotheses",))
def _verify_device_batch(desc_s, kpv_s, pcv_s, pc_s, uv_s, node_q, node_t,
                         iis, jjs, fx, fy, cx, cy, keys,
                         ratio, threshold_n, num_hypotheses: int):
    """8-wide vmapped _verify_device: during a sustained revisit every
    keyframe passes the candidate gate, and one verification program PER
    candidate would serialize on the device; one vmapped program per
    8-candidate bucket amortizes both the dispatch
    and the device-side matmul setup.  Padding pairs verify (0, 0) and are
    discarded by the caller."""
    return jax.vmap(
        lambda i, j, key: _verify_device.__wrapped__(
            desc_s, kpv_s, pcv_s, pc_s, uv_s, node_q, node_t, i, j,
            fx, fy, cx, cy, key, ratio, threshold_n,
            num_hypotheses=num_hypotheses))(iis, jjs, keys)


@functools.partial(jax.jit, static_argnames=("n_pad", "n_succ"))
def _build_graph(q_odom, t_odom, node_q, node_t, i0, wn,
                 loop_i, loop_j, loop_q, loop_t, loop_valid,
                 n_pad: int, n_succ: int):
    """Assemble the PGO problem over the LOOP WINDOW [i0, i0+wn) in ONE
    device program: nodes gathered from the corrected pose table,
    sequential odometry edges to n_succ successors (weight 1/s) computed
    batched, plus padded loop edges (weight 5; indices window-local).
    The reference restricts its pose graph to exactly this window —
    [first loop id, last loop id] — and builds it edge-by-edge
    (vo_loopclosing.cpp:747-780, 834-875).  Edge ordering matters: the
    n_succ·n_pad sequential edges come FIRST so pose_graph.optimize_banded
    can treat them as the block-tridiagonal band."""
    a = jnp.arange(n_pad)
    loop_pad = loop_i.shape[0]
    rows = jnp.minimum(i0 + a, q_odom.shape[0] - 1)
    q_o, t_o = q_odom[rows], t_odom[rows]
    ei, ej, eq, et, ev, ew = [], [], [], [], [], []
    Ta = SE3(q_o, t_o)
    for s in range(1, n_succ + 1):
        b = jnp.minimum(a + s, n_pad - 1)
        rel = se3m.compose(se3m.inverse(Ta), SE3(q_o[b], t_o[b]))
        ei.append(a.astype(jnp.int32))
        ej.append(b.astype(jnp.int32))
        eq.append(rel.q)
        et.append(rel.t)
        ev.append(a + s < wn)
        ew.append(jnp.full(n_pad, 1.0 / s, jnp.float32))
    ei.append(loop_i - i0); ej.append(loop_j - i0)
    eq.append(loop_q); et.append(loop_t)
    ev.append(loop_valid)
    ew.append(jnp.full(loop_pad, 5.0, jnp.float32))
    return pose_graph.PoseGraph(
        node_q=node_q[rows], node_t=node_t[rows], node_valid=a < wn,
        edge_i=jnp.concatenate(ei), edge_j=jnp.concatenate(ej),
        edge_q=jnp.concatenate(eq), edge_t=jnp.concatenate(et),
        edge_valid=jnp.concatenate(ev), edge_weight=jnp.concatenate(ew))


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _apply_pgo(q_s, t_s, q_odom_s, t_odom_s, g_q, g_t, i0, wn, n):
    """Write the optimized window poses back into rows [i0, i0+wn) of the
    pose table, recompute the map→odom drift from the LAST window keyframe
    (corrected_last ∘ odom_last⁻¹), and re-base every keyframe AFTER the
    window onto the new drift — the reference's post-PGO update
    (vo_loopclosing.cpp:889-941: T_odom_map accumulation from the last
    window node; kf_map_lc[i]->T_c_w = T_c_w_odom * T_odom_map for
    i > window end).  Keyframes BEFORE the window are untouched."""
    K = q_s.shape[0]
    n_pad = g_q.shape[0]
    a = jnp.arange(n_pad)
    in_win = a < wn
    idx = jnp.where(in_win, i0 + a, K)          # OOB rows dropped by scatter
    q_s = q_s.at[idx].set(g_q, mode="drop")
    t_s = t_s.at[idx].set(g_t, mode="drop")
    last = i0 + wn - 1
    T_mo = se3m.compose(
        SE3(q_s[last], t_s[last]),
        se3m.inverse(SE3(q_odom_s[last], t_odom_s[last])))
    after = (jnp.arange(K) > last) & (jnp.arange(K) < n)
    T_after = se3m.compose(T_mo, SE3(q_odom_s, t_odom_s))
    q_s = jnp.where(after[:, None], T_after.q, q_s)
    t_s = jnp.where(after[:, None], T_after.t, t_s)
    return q_s, t_s, T_mo.q, T_mo.t


@jax.jit
def _gate_rows(db, valid_rows, ks, lo, hi, nb_dist):
    """Loop-candidate gate for a BATCH of query keyframes, fully on device
    (isLoopCandidate, vo_loopclosing.cpp:520-589): for each query k —

      - the BoW similarity row and the best candidate in the temporal
        window [lo, hi);
      - the ADAPTIVE minimum score: min similarity of the query to its own
        recent temporal neighbours [hi, k) above 0.001, clamped to 0.4
        (lines 547-554) — self-similar scenes raise the bar automatically;
      - neighbour consistency: other window keyframes within nb_dist
        (lcKFMaxDist) of the candidate scoring ≥ 0.8·lc_min (lines 560-570).

    Returns an (M, 4) packed array [cand_idx, best, n_close, lc_min] — the
    ONLY thing fetched to the host in the steady-state search path, instead
    of the full similarity row per keyframe."""
    idxs = jnp.arange(db.shape[0])

    def one(k, lo_k, hi_k):
        sims = bow.score_database(db[k], db, valid_rows)
        in_win = (idxs >= lo_k) & (idxs < hi_k)
        sims_w = jnp.where(in_win, sims, -jnp.inf)
        cand = jnp.argmax(sims_w)
        best = sims_w[cand]
        recent = (idxs >= hi_k) & (idxs < k) & (sims > 0.001)
        lc_min = jnp.min(jnp.where(recent, sims, 1.0))
        lc_min = jnp.minimum(lc_min, 0.4)
        nb = in_win & (jnp.abs(idxs - cand) <= nb_dist) & (idxs != cand)
        close = jnp.sum(nb & (sims >= 0.8 * lc_min))
        return jnp.stack([cand.astype(jnp.float32), best,
                          close.astype(jnp.float32), lc_min])

    return jax.vmap(one)(ks, lo, hi)


def _gate_decision(row, lo: int, hi: int, cfg: LoopConfig):
    """Host-side accept decision over a _gate_rows row: returns the
    candidate index or None.  Adaptive bar max(minScore, lc_min) +
    neighbour consistency (isLoopCandidate, vo_loopclosing.cpp:547-575)."""
    if hi <= lo:
        return None
    cand, best, close, lc_min = int(row[0]), float(row[1]), int(row[2]), \
        float(row[3])
    if best < max(cfg.min_score, lc_min):
        return None
    if close < cfg.nkf_closest:
        return None
    return cand


class _PoseView:
    """Indexable view of a (K, 4)/(K, 3) device pose table as SE3 rows —
    keeps the `lc.kf_T_wc[i]` accessor API over the batched storage."""

    def __init__(self, owner, q_name: str, t_name: str):
        self._owner, self._q, self._t = owner, q_name, t_name

    def __getitem__(self, i) -> SE3:
        return SE3(getattr(self._owner, self._q)[i],
                   getattr(self._owner, self._t)[i])

    def __len__(self) -> int:
        return self._owner.count


@dataclasses.dataclass
class LoopClosure:
    """Record of an accepted loop closure."""

    kf_i: int              # older keyframe index
    kf_j: int              # newer keyframe index
    num_inliers: int
    T_ij: SE3              # measured relative pose between nodes i → j


class LoopCloser:
    """Keyframe database + loop detection + pose-graph correction."""

    def __init__(self, cfg: LoopConfig, cam: StereoCamera,
                 vocab: Optional[bow.Vocabulary] = None,
                 depth_mode: bool = False, mesh=None,
                 pgo_device=None, dump_dir: Optional[str] = None,
                 device=None):
        self.cfg = cfg
        self.cam = cam
        self.vocab = vocab
        self.depth_mode = depth_mode
        # Optional dedicated device for the WHOLE loop node (store + ingest +
        # gate + verify): the reference runs loop closing as its own nodelet
        # on spare CPU cores, never taxing tracking (vo_loopclosing.cpp:
        # 1106-1118); with a second device the batched ingest/gate programs
        # dispatch there asynchronously and overlap the frontend device's
        # next chunk — the single-device mode pays the ingest inline.
        # Only the gathered keyframe images cross devices, not the stores.
        self.device = device
        # Debug-dump directory: similarity-matrix txt every 10 KFs and the
        # pose graph before/after each PGO run (the reference writes these to
        # hard-coded home paths, vo_loopclosing.cpp:439-452,879,887).
        self.dump_dir = dump_dir
        # Optional separate device for the PGO solve — the reference runs
        # PGO on its own pgoProcess thread (vo_loopclosing.cpp:393-518);
        # here the graph program can be placed on a different chip so it
        # overlaps the frontend/backend devices via async dispatch.
        self.pgo_device = pgo_device
        K, F, V = cfg.max_keyframes, cfg.num_orb_features, cfg.vocab_words
        # BoW database lives ON DEVICE: similarity against the whole database
        # is a single device matvec with no host round-trip of the (K, V)
        # matrix (the reference's O(N) per-KF scoring loop,
        # vo_loopclosing.cpp:421-436, shipped each score over a function
        # call; shipping 2048x4096 floats per query would be worse).
        # With a mesh, rows are additionally sharded over the `kf` axis so
        # map-scale place recognition splits across chips (parallel.dist_loop).
        self.mesh = mesh
        self.bow_db = jnp.zeros((K, V), jnp.float32)
        if mesh is not None:
            from ..parallel import dist_loop

            self._dist = dist_loop
            self.bow_db, _ = dist_loop.shard_db(
                mesh, self.bow_db, jnp.zeros((K,), bool))
        else:
            self._dist = None
        # ORB keypoint/descriptor/3D store is DEVICE-resident like the BoW
        # database: verification gathers two rows on device and returns only
        # gate statistics (the reference keeps a host vector<KeyFrameLC> and
        # re-touches full keyframes per candidate, vo_loopclosing.cpp:99-112).
        self.kf_uv = jnp.zeros((K, F, 2), jnp.float32)
        self.kf_desc = jnp.zeros((K, F, 8), jnp.uint32)
        self.kf_kp_valid = jnp.zeros((K, F), bool)
        self.kf_pc = jnp.zeros((K, F, 3), jnp.float32)  # keypoint 3D, camera frame
        self.kf_pc_valid = jnp.zeros((K, F), bool)
        self.kf_frame_id = np.full(K, -1, np.int64)
        # Odometry (frontend) poses and PGO-corrected node poses, as T_w_c —
        # batched (K, 4)/(K, 3) device tables (not per-KF Python objects:
        # under a remote-dispatch backend every eager op on a scalar pose is
        # a round trip, and PGO edge construction touches all of them).
        self.kf_q_odom = jnp.tile(jnp.asarray([1.0, 0, 0, 0], jnp.float32), (K, 1))
        self.kf_t_odom = jnp.zeros((K, 3), jnp.float32)
        self.kf_q = jnp.tile(jnp.asarray([1.0, 0, 0, 0], jnp.float32), (K, 1))
        self.kf_t = jnp.zeros((K, 3), jnp.float32)
        if device is not None:
            (self.bow_db, self.kf_uv, self.kf_desc, self.kf_kp_valid,
             self.kf_pc, self.kf_pc_valid, self.kf_q_odom, self.kf_t_odom,
             self.kf_q, self.kf_t) = jax.device_put(
                (self.bow_db, self.kf_uv, self.kf_desc, self.kf_kp_valid,
                 self.kf_pc, self.kf_pc_valid, self.kf_q_odom,
                 self.kf_t_odom, self.kf_q, self.kf_t), device)
        self.count = 0
        self.closures: list[LoopClosure] = []
        self.T_map_odom: SE3 = se3m.identity()   # drift: corrected ∘ odom⁻¹
        # PGO throttle (vo_loopclosing.cpp:160,487-495): during a sustained
        # revisit every keyframe closes a loop; loop EDGES accumulate but
        # the graph is re-optimized only once the newest loop's keyframe is
        # more than 2% of the keyframe count past the last PGO run.
        self._last_pgo_id = -5000
        self._desc_buffer: list = []  # (desc, valid) device pairs until vocab trains
        # Debug mode keeps host copies of keyframe left images so accepted
        # loops can render a side-by-side match image (vo_loopclosing.cpp:
        # 689-722); steady-state runs keep nothing image-sized on the host.
        self._kf_imgs: list | None = [] if dump_dir is not None else None
        # In-run vocabulary bookkeeping (refresh applies only to
        # vocabularies trained here, never to a pretrained one).  Refreshes
        # repeat on a DOUBLING schedule (vocab_refresh_at, 2x, 4x, ...): a
        # one-shot refresh at KF 64 leaves a KITTI-length run scoring its
        # tail against an opening-scene word set — the same bias the refresh
        # exists to fix; doubling bounds the retrain count at O(log n).
        self._in_run_vocab = False
        self._next_vocab_refresh = cfg.vocab_refresh_at

    # SE3-row accessors over the batched pose tables (API compatibility).
    @property
    def kf_T_wc(self) -> _PoseView:
        return _PoseView(self, "kf_q", "kf_t")

    @property
    def kf_T_wc_odom(self) -> _PoseView:
        return _PoseView(self, "kf_q_odom", "kf_t_odom")

    # ------------------------------------------------------------------ add
    def add_keyframe(self, img_l, img_r, T_c_w_odom: SE3, frame_id: int):
        """Thread-A equivalent: features, BoW, keypoint depth (vo_loopclosing
        .cpp:181-392).  Returns this keyframe's index."""
        cfg = self.cfg
        k = self.count
        if k >= self.bow_db.shape[0]:
            # Grow the database instead of crashing at capacity: KITTI-length
            # sequences exceed any fixed budget.  Doubling keeps recompiles
            # (jitted programs are shape-keyed) at O(log n) over a run.
            self._grow()
        img_l = jnp.asarray(img_l)
        img_r = jnp.asarray(img_r)
        # Depth for ORB keypoints: rectified stereo LK (the reference's
        # stereo recovery, vo_loopclosing.cpp:262-351) or, in RGB-D mode,
        # a depth-image lookup (img_r is a depth image, not intensity —
        # running stereo LK against it would fabricate garbage depths).
        uv, desc, kp_valid, p_c, pc_valid = _ingest(
            img_l, img_r, self.cam, cfg.num_orb_features, self.depth_mode)

        (self.kf_uv, self.kf_desc, self.kf_kp_valid, self.kf_pc,
         self.kf_pc_valid) = _store_set_rows(
            self.kf_uv, self.kf_desc, self.kf_kp_valid, self.kf_pc,
            self.kf_pc_valid, jnp.asarray(k, jnp.int32),
            uv, desc, kp_valid, p_c, pc_valid)
        self.kf_frame_id[k] = frame_id
        # New nodes enter at their drift-corrected pose (one device program).
        (self.kf_q_odom, self.kf_t_odom, self.kf_q, self.kf_t) = _pose_set_rows(
            self.kf_q_odom, self.kf_t_odom, self.kf_q, self.kf_t,
            jnp.asarray(k, jnp.int32), T_c_w_odom.q, T_c_w_odom.t,
            self.T_map_odom.q, self.T_map_odom.t)
        if self.vocab is None:
            # Keep device handles for the (one-time) vocabulary training;
            # fetching here would cost two host round trips on EVERY
            # keyframe, forever.
            self._desc_buffer.append((desc, kp_valid))

        if self.vocab is None and k + 1 >= 8:
            self._train_vocab()
        if self.vocab is not None:
            self._set_db_row(k, bow.transform(self.vocab, desc, kp_valid))
        self.count += 1
        self._maybe_refresh_vocab()
        if self._kf_imgs is not None:
            self._kf_imgs.append(np.asarray(img_l))
        if self.dump_dir is not None and self.count % 10 == 0:
            self.dump_sim_matrix(
                f"{self.dump_dir}/sim_matrix_{self.count:05d}.txt")
        return k

    def add_keyframes_batch(self, imgs_l, imgs_r, sel, q, t, frame_ids):
        """Thread-A ingest for a whole CHUNK of keyframes as ~2 device
        programs (one fused ingest+scatter, one batched BoW transform) —
        the chunked-replay steady path (see _ingest_rows).

        Args:
          imgs_l/imgs_r: (T, H, W) device image stacks (the chunk's frames).
          sel: host int sequence — chunk-frame indices that are keyframes.
          q/t: (M, 4)/(M, 3) host arrays — T_c_w odometry poses per keyframe.
          frame_ids: host int sequence of global frame ids.
        Returns the list of assigned keyframe store indices.
        """
        M = len(sel)
        if M == 0:
            return []
        while self.count + M > self.bow_db.shape[0]:
            self._grow()
        # The batch runs at FIXED program shapes {32, 8}: the fused ingest
        # program is expensive to compile, and per-chunk keyframe counts
        # jitter — shape-keying the program on the batch size caused fresh
        # mid-run compiles that dwarfed the work itself.  Each program
        # dispatch also carries fixed overhead, so a typical ~23-keyframe
        # chunk runs as ONE 32-wide program instead of three 8-wide ones;
        # small remainders use the 8-wide shape.
        sel = np.asarray(sel, np.int32)
        q = np.asarray(q, np.float32)
        t = np.asarray(t, np.float32)
        imgs_l = jnp.asarray(imgs_l)
        imgs_r = jnp.asarray(imgs_r)
        old_count = self.count
        blocks = []
        off = 0
        while M - off > 16:
            blocks.append((off, 32))
            off += min(32, M - off)
        while M - off > 4:
            blocks.append((off, 8))
            off += min(8, M - off)
        while off < M:
            # 4-wide remainder: the multi-sequence DP path ingests ~3-4
            # keyframes per sequence per chunk — an 8-wide block there
            # wastes half its device time on padding (S such programs
            # serialize per chunk).
            blocks.append((off, 4))
            off += min(4, M - off)
        for b0, B in blocks:
            bM = min(B, M - b0)
            sel_b = np.concatenate(
                [sel[b0:b0 + bM], np.full(B - bM, sel[b0 + bM - 1],
                                          np.int32)])
            sel_dev = jnp.asarray(sel_b)
            il, ir = imgs_l, imgs_r
            if self.device is not None:
                # Two-chip mode: gather the block's frames on the frontend
                # chip and ship only the (B, H, W) stacks across; every loop
                # program below then dispatches on the loop chip,
                # overlapping the frontend chip's next chunk.
                il = jax.device_put(_gather_frames(imgs_l, sel_dev),
                                    self.device)
                ir = jax.device_put(_gather_frames(imgs_r, sel_dev),
                                    self.device)
                sel_dev = jnp.asarray(np.arange(B, dtype=np.int32))
            rows = np.arange(self.count + b0, self.count + b0 + B,
                             dtype=np.int32)
            row_valid = np.arange(B) < bM
            q_p = np.concatenate(
                [q[b0:b0 + bM],
                 np.tile(np.asarray([1.0, 0, 0, 0], np.float32),
                         (B - bM, 1))])
            t_p = np.concatenate(
                [t[b0:b0 + bM], np.zeros((B - bM, 3), np.float32)])
            if self.vocab is not None and self._dist is None:
                # Steady path: ingest + BoW transform + db scatter as ONE
                # program per block.
                (self.bow_db, self.kf_uv, self.kf_desc, self.kf_kp_valid,
                 self.kf_pc, self.kf_pc_valid, self.kf_q_odom,
                 self.kf_t_odom, self.kf_q, self.kf_t, desc,
                 kpv) = _ingest_rows_bow(
                    self.bow_db, self.kf_uv, self.kf_desc,
                    self.kf_kp_valid, self.kf_pc, self.kf_pc_valid,
                    self.kf_q_odom, self.kf_t_odom, self.kf_q, self.kf_t,
                    self.vocab.words_pm1, self.vocab.idf, il, ir,
                    sel_dev, jnp.asarray(rows), jnp.asarray(row_valid),
                    jnp.asarray(q_p), jnp.asarray(t_p),
                    self.T_map_odom.q, self.T_map_odom.t, self.cam,
                    num_features=self.cfg.num_orb_features,
                    depth_mode=self.depth_mode)
                continue
            (self.kf_uv, self.kf_desc, self.kf_kp_valid, self.kf_pc,
             self.kf_pc_valid, self.kf_q_odom, self.kf_t_odom, self.kf_q,
             self.kf_t, desc, kpv) = _ingest_rows(
                self.kf_uv, self.kf_desc, self.kf_kp_valid, self.kf_pc,
                self.kf_pc_valid, self.kf_q_odom, self.kf_t_odom, self.kf_q,
                self.kf_t, il, ir,
                sel_dev, jnp.asarray(rows), jnp.asarray(row_valid),
                jnp.asarray(q_p), jnp.asarray(t_p),
                self.T_map_odom.q, self.T_map_odom.t, self.cam,
                num_features=self.cfg.num_orb_features,
                depth_mode=self.depth_mode)
            if self.vocab is None:
                # Stacked device handles; _train_vocab fetches at training.
                self._desc_buffer.append(
                    (desc, kpv & jnp.asarray(row_valid)[:, None]))
            else:
                self._set_db_rows_batch(rows, row_valid,
                                        sharded_rows=list(
                                            rows[:bM].tolist()))
        ks = list(range(self.count, self.count + M))
        self.kf_frame_id[old_count:old_count + M] = np.asarray(
            frame_ids, np.int64)
        self.count += M
        if self.vocab is None and self.count >= 8:
            self._train_vocab()       # back-fills ALL rows incl. this batch
        self._maybe_refresh_vocab()
        if self._kf_imgs is not None:
            self._kf_imgs.extend(np.asarray(imgs_l[jnp.asarray(sel)]))
        if self.dump_dir is not None and \
                old_count // 10 != self.count // 10:
            self.dump_sim_matrix(
                f"{self.dump_dir}/sim_matrix_{self.count:05d}.txt")
        return ks

    def _set_db_rows_batch(self, rows, row_valid, sharded_rows=None):
        """Batched BoW transform + db scatter for stored descriptor rows —
        issued in FIXED blocks of 8 so _bow_rows compiles exactly once
        regardless of batch/back-fill size."""
        if self._dist is not None:
            # Mesh-sharded database: keep the per-row sharded row-set path.
            for k in (sharded_rows if sharded_rows is not None
                      else [int(r) for r, v in zip(rows, row_valid) if v]):
                self._set_db_row(
                    k, bow.transform(self.vocab, self.kf_desc[k],
                                     self.kf_kp_valid[k]))
            return
        B = 8
        rows = np.asarray(rows, np.int32)
        row_valid = np.asarray(row_valid, bool)
        for b0 in range(0, len(rows), B):
            rb, vb = rows[b0:b0 + B], row_valid[b0:b0 + B]
            if not vb.any():
                continue
            if len(rb) < B:
                rb = np.concatenate([rb, np.full(B - len(rb), rb[-1],
                                                 np.int32)])
                vb = np.concatenate([vb, np.zeros(B - len(vb), bool)])
            self.bow_db = _bow_rows(
                self.bow_db, self.vocab.words_pm1, self.vocab.idf,
                self.kf_desc, self.kf_kp_valid,
                jnp.asarray(rb), jnp.asarray(vb))

    # -------------------------------------------------------------- debug IO
    def sim_matrix(self) -> np.ndarray:
        """Full pairwise BoW similarity over stored keyframes (count, count)
        — computed as one batched device op rather than the reference's
        accumulated row-by-row host matrix (vo_loopclosing.cpp:421-452)."""
        if self.vocab is None or self.count == 0:
            return np.zeros((self.count, self.count), np.float32)
        valid = jnp.arange(self.bow_db.shape[0]) < self.count
        S = jax.vmap(lambda q: bow.score_database(q, self.bow_db, valid))(
            self.bow_db)
        return np.asarray(S)[: self.count, : self.count]

    def dump_sim_matrix(self, path: str) -> None:
        np.savetxt(path, self.sim_matrix(), fmt="%.6f")

    def _dump_graph(self, tag: str) -> None:
        """Pose-graph snapshot (the reference's optimizer.save of
        before.g2o/after.g2o) as an .npz of node poses + edge list."""
        n = self.count
        np.savez(
            f"{self.dump_dir}/pose_graph_{tag}.npz",
            node_q=np.asarray(self.kf_q[:n]),
            node_t=np.asarray(self.kf_t[:n]),
            loops=np.asarray([[c.kf_i, c.kf_j, c.num_inliers]
                              for c in self.closures], np.int64),
        )

    def _grow(self) -> None:
        """Double the keyframe-dimension capacity of every device table."""
        K = self.bow_db.shape[0]

        def zpad(a):
            return jnp.concatenate(
                [a, jnp.zeros((K,) + a.shape[1:], a.dtype)])

        def qpad(a):
            ident = jnp.tile(jnp.asarray([1.0, 0, 0, 0], a.dtype), (K, 1))
            return jnp.concatenate([a, ident])

        self.bow_db = zpad(self.bow_db)
        if self._dist is not None:
            self.bow_db, _ = self._dist.shard_db(
                self.mesh, self.bow_db, jnp.zeros((2 * K,), bool))
        self.kf_uv = zpad(self.kf_uv)
        self.kf_desc = zpad(self.kf_desc)
        self.kf_kp_valid = zpad(self.kf_kp_valid)
        self.kf_pc = zpad(self.kf_pc)
        self.kf_pc_valid = zpad(self.kf_pc_valid)
        self.kf_q_odom = qpad(self.kf_q_odom)
        self.kf_t_odom = zpad(self.kf_t_odom)
        self.kf_q = qpad(self.kf_q)
        self.kf_t = zpad(self.kf_t)
        self.kf_frame_id = np.concatenate(
            [self.kf_frame_id, np.full(K, -1, np.int64)])

    def _set_db_row(self, k: int, row) -> None:
        if self._dist is not None:
            self.bow_db = self._dist.set_row(self.mesh, self.bow_db,
                                             jnp.asarray(k), row)
        else:
            self.bow_db = _db_set_row(self.bow_db, k, row)

    def _train_vocab(self):
        """Train the vocabulary from keyframes seen so far (the reference
        instead loads a pre-trained DBoW3 file, vo_loopclosing.cpp:1095-1102,
        which the repo does not ship)."""
        # Fetch each buffered device pair at most ONCE: training re-runs on
        # every keyframe until enough descriptors exist, and re-fetching the
        # whole buffer each attempt would make that path O(k^2) in host
        # round trips.  Fetched entries are cached back as host arrays.
        self._desc_buffer = [
            e if isinstance(e, np.ndarray)
            else np.asarray(e[0])[np.asarray(e[1])]
            for e in self._desc_buffer
        ]
        all_desc = np.concatenate(self._desc_buffer, axis=0)
        if len(all_desc) < self.cfg.vocab_words // 2:
            return
        self.vocab = bow.train(
            jnp.asarray(all_desc), np.ones(len(all_desc), bool),
            num_words=self.cfg.vocab_words, iters=6,
        )
        self._in_run_vocab = True
        self._desc_buffer.clear()
        # Back-fill BoW vectors for every stored keyframe (one batched
        # program; descriptors are already resident in kf_desc).
        n = self.count
        n_pad = ((n + 7) // 8) * 8
        self._set_db_rows_batch(np.arange(n_pad, dtype=np.int32),
                                np.arange(n_pad) < n,
                                sharded_rows=list(range(n)))

    def _maybe_refresh_vocab(self):
        """Retrain the IN-RUN vocabulary each time the run DOUBLES past its
        last training point (LoopConfig.vocab_refresh_at, 2x, 4x, ...), then
        back-fill every BoW row in one batched program.  A vocabulary whose
        words all come from the opening scene scores late-sequence revisits
        against a near-degenerate word set; the reference sidesteps this
        with an offline-trained DBoW3 file (vo_loopclosing.cpp:1095-1102),
        which the in-run path replaces.  The doubling schedule bounds the
        retrain count at O(log n) over a run while keeping the training set
        never more than 2x staler than the database."""
        cfg = self.cfg
        if (not self._in_run_vocab or cfg.vocab_refresh_at <= 0
                or self.count < self._next_vocab_refresh):
            return
        n = self.count
        # Fetch at POWER-OF-2 row buckets and train on a FIXED-size sample:
        # `kf_desc[:count]` sliced at the raw count gave every refresh a
        # fresh array shape, and shape-varying slices + a shape-varying
        # k-means program meant a multi-second XLA compile PER REFRESH,
        # some inside the bench's timed window.  Pow-2 buckets recur across
        # refreshes and runs;
        # the fixed 8192-descriptor sample (with replacement when fewer are
        # valid) keeps bow.train at ONE compiled shape forever.
        n_b = 1 << (n - 1).bit_length()
        n_b = min(n_b, self.kf_desc.shape[0])
        desc = np.asarray(self.kf_desc[:n_b])[:n]
        kpv = np.asarray(self.kf_kp_valid[:n_b])[:n]
        all_desc = desc[kpv]
        sel = np.random.default_rng(n).choice(len(all_desc), 8192,
                                              replace=len(all_desc) < 8192)
        all_desc = all_desc[sel]
        self.vocab = bow.train(
            jnp.asarray(all_desc), np.ones(len(all_desc), bool),
            num_words=cfg.vocab_words, iters=6, seed=1)
        n_pad = ((n + 7) // 8) * 8
        self._set_db_rows_batch(np.arange(n_pad, dtype=np.int32),
                                np.arange(n_pad) < n,
                                sharded_rows=list(range(n)))
        self._next_vocab_refresh = max(self._next_vocab_refresh * 2, n + 1)

    # --------------------------------------------------------------- search
    def detect_loop(self, k: int) -> Optional[LoopClosure]:
        """Thread-B candidate search + geometric check for keyframe k."""
        hits = self.detect_loops_batch([k])
        return hits[0] if hits else None

    def detect_loops_batch(self, ks) -> list:
        """Candidate search + geometric check for a BATCH of keyframes:
        one device gate program + ONE (M, 4) fetch for the whole batch;
        geometric verification (rare) per surviving candidate.  Returns
        accepted LoopClosures."""
        return self.decide_loops(self.gate_candidates(ks))

    def gate_candidates(self, ks):
        """Dispatch the batched on-device candidate gate WITHOUT fetching
        the result — returns an opaque pending handle for decide_loops.
        The chunked runner resolves it one chunk later, bundling the (M, 4)
        fetch with the next chunk's packed-output fetch so the steady-state
        loop path adds ZERO extra host round trips (the reference's search
        thread lags ingest the same way, vo_loopclosing.cpp:393-518)."""
        cfg = self.cfg
        ks = [k for k in ks if k >= cfg.kf_start]
        if self.vocab is None or not ks:
            return None
        if self._dist is not None:
            # Mesh-sharded database: per-query sharded search path stays
            # synchronous (resolved inside decide_loops).
            return ("sync", ks)
        valid_rows = jnp.arange(self.bow_db.shape[0]) < self.count
        # Search window [hi − search_window, hi): the reference's HARDCODED
        # 5000-KF lookback before the temporal gate (vo_loopclosing.cpp:
        # 529-534); kf_max_dist (YAML lcKFMaxDist) is only the neighbour-
        # consistency radius passed to the gate (line 568).
        # Pad the query batch to a multiple of 32: the gate program is
        # shape-keyed on M, and per-chunk keyframe counts jitter by a few —
        # unpadded, every new M cost a fresh remote compile mid-run (32
        # bounds the shape set to {32, 64} at chunk 64).
        M = len(ks)
        Mp = ((M + 31) // 32) * 32
        ks_p = list(ks) + [ks[-1]] * (Mp - M)
        his = np.asarray([k - cfg.kf_dist for k in ks_p], np.int32)
        los = np.asarray([max(0, h - cfg.search_window) for h in his],
                         np.int32)
        rows_dev = _gate_rows(
            self.bow_db, valid_rows, jnp.asarray(np.asarray(ks_p, np.int32)),
            jnp.asarray(los), jnp.asarray(his),
            jnp.asarray(cfg.kf_max_dist, jnp.int32))
        return ("rows", ks, los[:M], his[:M], rows_dev)

    def pending_rows(self, pending):
        """The device array inside a gate_candidates handle (None if the
        handle needs no fetch) — lets callers bundle its transfer into an
        existing jax.device_get."""
        return pending[4] if pending is not None and pending[0] == "rows" \
            else None

    def decide_loops(self, pending, rows_np=None) -> list:
        """Resolve a gate_candidates handle: host accept decisions + (rare)
        geometric verification.  rows_np: optionally the pre-fetched gate
        rows (from a bundled device_get); fetched here otherwise."""
        return self.resolve_verify(self.dispatch_verify(pending, rows_np))

    def dispatch_verify(self, pending, rows_np=None):
        """Resolve a gate_candidates handle's HOST decisions and dispatch
        geometric verification WITHOUT fetching its statistics — the async
        half of decide_loops.  The pipelined runner resolves the returned
        handle one chunk later, bundling the stats fetch into the next
        chunk's packed device_get, so verification never stalls the frame
        path (the reference's free-running search thread lags ingest the
        same way, vo_loopclosing.cpp:393-518).  Returns None (nothing to
        verify), ("done", closures) when the mesh-sharded path resolved
        synchronously, or ("verify", cands, stats_dev)."""
        if pending is None:
            return None
        if pending[0] == "sync":
            out = [lc for k in pending[1]
                   for lc in (self._detect_sharded(k),) if lc is not None]
            return ("done", out)
        _, ks, los, his, rows_dev = pending
        rows = np.asarray(rows_dev) if rows_np is None else rows_np
        cands = []
        for (k, lo, hi, row) in zip(ks, los, his, rows):
            cand = _gate_decision(row, lo, hi, self.cfg)
            if cand is not None:
                cands.append((cand, k))
        if not cands:
            return None
        # Verify candidates in 8-wide vmapped buckets; ALL buckets' results
        # resolve in ONE bundled device_get later: during a sustained
        # revisit every keyframe passes the gate, and per-candidate programs
        # would serialize on the device with a host fetch each.
        cfg8 = self.cfg
        B = 8
        stats_dev = []
        for b0 in range(0, len(cands), B):
            bucket = cands[b0:b0 + B]
            pairs = bucket + [bucket[-1]] * (B - len(bucket))
            iis = jnp.asarray([p[0] for p in pairs], jnp.int32)
            jjs = jnp.asarray([p[1] for p in pairs], jnp.int32)
            keys = jnp.stack([jax.random.PRNGKey(i * 7919 + j)
                              for (i, j) in pairs])
            stats_dev.append(_verify_device_batch(
                self.kf_desc, self.kf_kp_valid, self.kf_pc_valid,
                self.kf_pc, self.kf_uv, self.kf_q, self.kf_t, iis, jjs,
                self.cam.fx, self.cam.fy, self.cam.cx, self.cam.cy, keys,
                cfg8.ratio_max, 3.0 / float(self.cam.fx),
                num_hypotheses=cfg8.ransac_hypotheses))
        return ("verify", cands, stats_dev)

    def pending_verify_arrays(self, handle):
        """The device arrays inside a dispatch_verify handle (None if no
        fetch is needed) — lets callers bundle the stats transfer into an
        existing jax.device_get."""
        return handle[2] if handle is not None and handle[0] == "verify" \
            else None

    def resolve_verify(self, handle, stats=None) -> list:
        """Resolve a dispatch_verify handle: fetch (or take the bundled)
        verification statistics and run the host accept gates.  Returns the
        accepted LoopClosures (also appended to self.closures)."""
        if handle is None:
            return []
        if handle[0] == "done":
            return handle[1]
        _, cands, stats_dev = handle
        if stats is None:
            stats = jax.device_get(stats_dev)
        B = 8
        out = []
        for b0, block in zip(range(0, len(cands), B), stats):
            for off, (i, j) in enumerate(cands[b0:b0 + B]):
                vals = [a[off] for a in block]
                lc = self._verify_accept(i, j, vals)
                if lc is not None:
                    out.append(lc)
        return out

    def _detect_sharded(self, k: int) -> Optional[LoopClosure]:
        """Candidate gate on a kf-sharded database (mesh mode): the sharded
        matvec + argmax runs per query; the neighbour check fetches the
        candidate's local window only."""
        cfg = self.cfg
        valid_rows = jnp.arange(self.bow_db.shape[0]) < self.count
        sims = np.asarray(self._dist.score_database_sharded(
            self.mesh, self.bow_db[k], self.bow_db, valid_rows))[: self.count]
        hi = k - cfg.kf_dist
        lo = max(0, hi - cfg.search_window)
        if hi <= lo:
            return None
        window = sims[lo:hi]
        cand = int(np.argmax(window)) + lo
        best = float(sims[cand])
        # Same adaptive gate as _gate_rows (isLoopCandidate, 547-575).
        recent = sims[hi:k]
        recent = recent[recent > 0.001]
        lc_min = min(float(recent.min()) if len(recent) else 1.0, 0.4)
        if best < max(cfg.min_score, lc_min):
            return None
        idxs = np.arange(lo, hi)
        nb = (np.abs(idxs - cand) <= cfg.kf_max_dist) & (idxs != cand)
        close = int(np.sum(window[nb] >= 0.8 * lc_min))
        if close < cfg.nkf_closest:
            return None
        return self._verify(cand, k)

    def _verify(self, i: int, j: int) -> Optional[LoopClosure]:
        """Geometric check (isLoopClosureKF, 591-729): mutual ratio matching
        + PnP RANSAC + translation/rotation accept gates."""
        return self._verify_accept(
            i, j, jax.device_get(self._verify_dispatch(i, j)))

    def _verify_dispatch(self, i: int, j: int):
        """Dispatch the one-program geometric verification for candidate
        pair (i, j) WITHOUT fetching: 3D from old KF i (world frame via its
        corrected node pose), 2D from j — matching, PnP RANSAC, and gate
        statistics all run on device over the resident store; only six
        scalars/vectors ever cross to the host.  decide_loops bundles many
        candidates' fetches into one device_get."""
        cfg = self.cfg
        return _verify_device(
            self.kf_desc, self.kf_kp_valid, self.kf_pc_valid, self.kf_pc,
            self.kf_uv, self.kf_q, self.kf_t,
            jnp.asarray(i, jnp.int32), jnp.asarray(j, jnp.int32),
            self.cam.fx, self.cam.fy, self.cam.cx, self.cam.cy,
            jax.random.PRNGKey(i * 7919 + j),
            cfg.ratio_max, 3.0 / float(self.cam.fx),
            num_hypotheses=cfg.ransac_hypotheses,
        )

    def _verify_accept(self, i: int, j: int, stats) -> Optional[LoopClosure]:
        """Host-side accept gates over fetched verification statistics."""
        cfg = self.cfg
        q_ij, t_ij, n_match, n_inl, dt, dr = stats
        n_match, n_inl = int(n_match), int(n_inl)
        if n_match < cfg.min_pts:
            return None
        if n_inl < cfg.min_pts or n_inl < cfg.ratio_ransac * n_match:
            return None
        # Accept gates vs the current (drifted) estimate of j
        # (‖t‖ < 3 m, ‖log R‖ < 1.5 — vo_loopclosing.cpp:686).
        if float(dt) > cfg.max_trans or float(dr) > cfg.max_rot:
            return None
        # T_ij stays HOST-side numpy: every optimize_graph rebuilds the
        # loop-edge list with np.asarray(lc.T_ij.*) — device-resident
        # closures would pay a host fetch per edge per event.
        lc = LoopClosure(i, j, n_inl, SE3(np.asarray(q_ij), np.asarray(t_ij)))
        self.closures.append(lc)
        if self._kf_imgs is not None and len(self._kf_imgs) > max(i, j):
            # Accepted-loop match image (the reference's main human
            # debugging surface for bad loops, vo_loopclosing.cpp:689-722).
            from ..viz import overlay

            mj, good = _match_pairs(
                self.kf_desc, self.kf_kp_valid, self.kf_pc_valid,
                jnp.asarray(i, jnp.int32), jnp.asarray(j, jnp.int32),
                cfg.ratio_max)
            img = overlay.draw_loop_match(
                self._kf_imgs[i], self._kf_imgs[j],
                np.asarray(self.kf_uv[i]), np.asarray(self.kf_uv[j]),
                np.asarray(mj), np.asarray(good))
            overlay.save_png(
                f"{self.dump_dir}/loop_match_{i:05d}_{j:05d}.png", img)
        return lc

    # ------------------------------------------------------------------ PGO
    # Above this window size the dense (n_pad, n_pad, 6, 6) normal-equation
    # solve (O(n³), 604 MB at 2048 nodes) switches to the O(n) block-
    # tridiagonal + Woodbury solver.  Small graphs keep the dense path: it
    # converges in fewer dispatches and its one-shot solve is faster than
    # two Thomas scans at these sizes.
    _BANDED_THRESHOLD = 256

    def optimize_graph(self):
        """Pose-graph optimization over the LOOP WINDOW [first loop id,
        last loop id] with sequential edges to 5 successors + accumulated
        loop edges; keyframes before the window stay fixed, keyframes after
        it are re-based onto the updated map→odom drift
        (loopClosureOnCovGraphG2ONew, 742-944)."""
        cfg = self.cfg
        n = self.count
        if not self.closures or n < 2:
            return
        # The reference's window: kf_prev_idx = min loop i, kf_curr_idx =
        # max loop j (vo_loopclosing.cpp:745-753); only those nodes enter
        # the graph, the first is held fixed.
        i0 = min(lc.kf_i for lc in self.closures)
        j1 = max(lc.kf_j for lc in self.closures)
        # PGO throttle (vo_loopclosing.cpp:487-495): a sustained revisit
        # accepts a loop at every keyframe; edges keep accumulating, but the
        # solve reruns only once the newest loop is > 2% of the keyframe
        # count past the last run ("Last loop is too close" otherwise).
        if j1 - self._last_pgo_id <= int(n / 100) * 2:
            return
        wn = j1 - i0 + 1
        # Pad node/edge counts to power-of-2 buckets: the solvers are jitted
        # per shape, and each XLA compile is expensive — bucketing bounds
        # recompiles at O(log n) over a run.
        n_pad = max(32, 1 << (wn - 1).bit_length())
        # Bound the loop-edge set (cfg.pgo_max_loop_edges): a sustained
        # revisit accepts a closure per keyframe, and unthinned the Woodbury
        # rank (6L) and the per-8-bucket compile count grow without bound —
        # caught by tests/test_longrun.py.  Thinning keeps the strongest
        # closure (most inliers) per j-ordered bucket: consecutive
        # (i,j),(i+1,j+1) closures are near-duplicate constraints.  The
        # window [i0, j1] still comes from ALL closures above.
        closures = self.closures
        cap = cfg.pgo_max_loop_edges
        if cap > 0 and len(closures) > cap:
            order = sorted(closures, key=lambda c: c.kf_j)
            bounds = np.linspace(0, len(order), cap + 1).astype(int)
            closures = [
                max(order[a:b], key=lambda c: c.num_inliers)
                for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
        # Loop edges are few; pad to 8-slot buckets (the Thomas multi-RHS
        # pass and the dense correction solve scale with 6x the bucket — a
        # 16-slot minimum made every warm event pay 97 RHS columns for a
        # handful of real edges).
        L = len(closures)
        loop_pad = max(8, 8 * ((L + 7) // 8))
        loop_i = np.zeros(loop_pad, np.int32)
        loop_j = np.zeros(loop_pad, np.int32)
        loop_q = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (loop_pad, 1))
        loop_t = np.zeros((loop_pad, 3), np.float32)
        loop_valid = np.zeros(loop_pad, bool)
        for e, lc in enumerate(closures):
            loop_i[e], loop_j[e] = lc.kf_i, lc.kf_j
            loop_q[e] = np.asarray(lc.T_ij.q)
            loop_t[e] = np.asarray(lc.T_ij.t)
            loop_valid[e] = True
        # Padding slots alias node 0; mark them i=j=0 so window-local
        # indices stay in range (they carry valid=False anyway).
        loop_i[L:] = i0
        loop_j[L:] = i0
        g = _build_graph(
            self.kf_q_odom, self.kf_t_odom, self.kf_q, self.kf_t,
            jnp.asarray(i0, jnp.int32), jnp.asarray(wn, jnp.int32),
            jnp.asarray(loop_i), jnp.asarray(loop_j), jnp.asarray(loop_q),
            jnp.asarray(loop_t), jnp.asarray(loop_valid),
            n_pad=n_pad, n_succ=cfg.seq_edge_successors)
        fixed = jnp.zeros(n_pad, bool).at[0].set(True)
        if self.dump_dir is not None:
            self._dump_graph(f"{self.count:05d}_before")
        if self.pgo_device is not None:
            g = jax.device_put(g, self.pgo_device)
            fixed = jax.device_put(fixed, self.pgo_device)
        if n_pad > self._BANDED_THRESHOLD:
            g2, _ = pose_graph.optimize_banded(
                g, fixed, band_edges=cfg.seq_edge_successors * n_pad,
                iters=min(cfg.pgo_iters, 20))
        else:
            g2, _ = pose_graph.optimize(g, fixed, iters=min(cfg.pgo_iters, 30))
        g2_q, g2_t = g2.node_q, g2.node_t
        if self.pgo_device is not None:
            # Bring the solved poses back next to the pose table.
            g2_q = jax.device_put(g2_q, self.kf_q.sharding)
            g2_t = jax.device_put(g2_t, self.kf_t.sharding)
        # Write corrected poses back into the pose table, re-base keyframes
        # after the window, and refresh the drift transform (tf map→odom)
        # in one program.
        (self.kf_q, self.kf_t, tmo_q, tmo_t) = _apply_pgo(
            self.kf_q, self.kf_t, self.kf_q_odom, self.kf_t_odom,
            g2_q, g2_t, jnp.asarray(i0, jnp.int32), jnp.asarray(wn, jnp.int32),
            jnp.asarray(n, jnp.int32))
        self.T_map_odom = SE3(tmo_q, tmo_t)
        self._last_pgo_id = j1
        if self.dump_dir is not None:
            self._dump_graph(f"{self.count:05d}_after")

    # ---------------------------------------------------------------- query
    def corrected_pose(self, T_c_w_odom: SE3) -> SE3:
        """Apply the current drift estimate to a frontend odometry pose —
        what the frontend's path republisher does with tf map→odom
        (vo_tracking.cpp:437-445)."""
        T_wc = se3m.compose(self.T_map_odom, se3m.inverse(T_c_w_odom))
        return se3m.inverse(T_wc)
