"""Single-controller SLAM pipeline: frontend + sliding-window BA (+ VIO).

Replaces the reference's three-ROS-nodelet architecture
(/root/reference/src/frontend/vo_tracking.cpp, src/backend/vo_localmap.cpp,
src/backend/vo_loopclosing.cpp with /vo_kf and /vo_localmap_feedback topics)
by a host-side orchestrator over jitted device programs:

  - tracker.track_frame          — per-frame frontend (one XLA program)
  - window_ba.add_keyframe/optimize — per-keyframe backend BA
  - vimotion.imu_feed_batch      — inter-frame IMU packets

Pipelining comes from JAX's async dispatch: the BA program launched at a
keyframe overlaps the next frontend frames; its Correction is applied one
frame later — the same "corrections arrive K frames late and are rebased"
semantics as the reference's feedback topic (f2f_tracking.cpp:189-219).

Dataset replay (process_frames) goes further: a whole chunk of frames —
tracking, keyframe insertion, the 12+8 Schur window BA, and the correction
feedback — runs as ONE device program (_chunk_fused), with a single packed
device fetch per chunk for host bookkeeping.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

import functools

from ..backend import window_ba
from ..config import SystemConfig
from ..frontend import tracker
from ..geometry import se3 as se3m
from ..geometry.camera import StereoCamera
from ..geometry.se3 import SE3
from ..vio import vimotion


@jax.jit
def _pack_outputs(outs, ba_costs=None, corr_valids=None):
    """Pack the per-frame FrameOutput fields (plus optional per-frame BA
    cost and correction-valid flag) into ONE (T, 12|14) array so the host
    needs a single device fetch per chunk instead of one per field."""
    cols = [
        outs.is_keyframe[:, None].astype(jnp.float32),
        outs.reset_backend[:, None].astype(jnp.float32),
        outs.status[:, None].astype(jnp.float32),
        outs.num_inliers[:, None].astype(jnp.float32),
        outs.mean_reproj_err[:, None],
        outs.T_c_w.q, outs.T_c_w.t,
    ]
    if ba_costs is not None:
        cols.append(ba_costs[:, None])
        cols.append(corr_valids[:, None].astype(jnp.float32))
    return jnp.concatenate(cols, axis=1)


@jax.jit
def _slice_tree(tree, i):
    """Row i of every leaf as ONE dispatched program (a plain tree.map of
    `a[i]` dispatches one gather per leaf — ~13 for a KeyframePacket)."""
    return jax.tree.map(lambda a: a[i], tree)


def _unpack_outputs(packed: np.ndarray):
    from ..frontend.tracker import FrameOutput

    return FrameOutput(
        T_c_w=SE3(packed[:, 5:9], packed[:, 9:12]),
        is_keyframe=packed[:, 0] > 0.5,
        reset_backend=packed[:, 1] > 0.5,
        num_inliers=packed[:, 3].astype(np.int32),
        mean_reproj_err=packed[:, 4],
        status=packed[:, 2].astype(np.int32),
    )


def _ba_tail(fcfg, bcfg, cam, null, fe, ba, out):
    """Shared backend tail of the fused scan bodies: reset handling,
    keyframe packet, and the conditional add_keyframe + window-BA optimize.
    Returns (ba, pkt, corr_new, cost)."""
    ba = jax.lax.cond(out.reset_backend,
                      lambda b: window_ba.reset(bcfg, b),
                      lambda b: b, ba)
    pkt = tracker.make_keyframe_packet(fe, out)

    def do_kf(b):
        st = window_ba.add_keyframe(bcfg, b, pkt)
        res = window_ba.optimize(bcfg, cam, st)
        return res.state, res.correction, res.cost

    def no_kf(b):
        return b, null, jnp.asarray(0.0, jnp.float32)

    ba, corr_new, cost = jax.lax.cond(out.is_keyframe, do_kf, no_kf, ba)
    return ba, pkt, corr_new, cost


def _fused_frame_step(fcfg, bcfg, cam, null, carry, xs):
    """One frame of the fused frontend+backend pipeline: apply pending
    Correction, track, and run the keyframe BA tail.  Shared by the
    single-sequence chunk scan (_chunk_fused) and the (S,)-batched
    multi-sequence DP variant (parallel.multiseq.system_chunk_batch)."""
    fe, ba, corr = carry
    i0, i1 = xs
    fe = tracker.apply_correction_(fe, corr)             # no-op when !valid
    fe, out = tracker.track_frame(fcfg, cam, fe, i0, i1)
    # KFMSG_CMD_RESET_LM reset + keyframe BA (vo_localmap.cpp:89-98).
    ba, pkt, corr_new, cost = _ba_tail(fcfg, bcfg, cam, null, fe, ba, out)
    return (fe, ba, corr_new), (out, pkt, corr_new, cost)


@functools.partial(jax.jit, static_argnames=("fcfg", "bcfg"))
def _chunk_fused(fcfg, bcfg, cam, fe_state, ba_state, corr, imgs0, imgs1):
    """Frontend tracking AND per-keyframe window BA for a whole chunk as ONE
    device program.

    A lax.scan over frames carries (tracker state, BA window, pending
    Correction); at keyframes a lax.cond runs add_keyframe + the full
    12+8 Schur LM optimize, and its Correction is applied to the tracker at
    the START of the next frame — the reference's per-frame feedback timing
    (corrections arrive one keyframe late, f2f_tracking.cpp:189-219) rather
    than the chunk-boundary approximation the previous host-loop path used.
    Eliminates every per-keyframe host dispatch and the host round trip
    between frontend and backend.

    Returns (fe_state, ba_state, pending corr, stacked (outs, pkts, corrs,
    costs)); `corrs` rows are null (valid=False) on non-keyframe frames.
    """
    null = window_ba.null_correction(bcfg)

    def step(carry, xs):
        return _fused_frame_step(fcfg, bcfg, cam, null, carry, xs)

    (fe_state, ba_state, corr), ys = jax.lax.scan(
        step, (fe_state, ba_state, corr), (imgs0, imgs1))
    return fe_state, ba_state, corr, ys


@functools.partial(jax.jit, static_argnames=("fcfg", "bcfg", "vcfg"))
def _chunk_fused_vio(fcfg, bcfg, vcfg, cam, T_i_c, fe_state, ba_state,
                     vio_state, corr, imgs0, imgs1, ts, acc, gyro, imu_t,
                     imu_valid):
    """_chunk_fused with the full VIO loop inside the scan step: per-frame
    IMU batch propagation (imu_feed_batch), feedforward pose query
    (get_frame_state), roll/pitch compensation of the vision pose
    (rp_compensate_pose, f2f_tracking.cpp:251-254) and vision→IMU bias
    feedback (correction_from_vision) — the whole feedforward-feedback loop
    the system is named after, with zero per-frame host dispatch.

    Args beyond _chunk_fused: ts (T,) image times; acc/gyro (T, P, 3),
    imu_t (T, P), imu_valid (T, P) — per-frame IMU sample batches padded to
    a fixed P (see pack_imu_frames).
    """
    null = window_ba.null_correction(bcfg)

    def step(carry, xs):
        return _fused_vio_frame_step(fcfg, bcfg, vcfg, cam, T_i_c, null,
                                     carry, xs)

    (fe_state, ba_state, vio_state, corr), ys = jax.lax.scan(
        step, (fe_state, ba_state, vio_state, corr),
        (imgs0, imgs1, ts, acc, gyro, imu_t, imu_valid))
    return fe_state, ba_state, vio_state, corr, ys


def _vio_frame_core(fcfg, vcfg, cam, T_i_c, fe, vio, corr, xs):
    """The VIO frame step minus the backend tail: IMU propagation →
    feedforward prior → track → RP blend → vision→IMU bias feedback.
    Shared by _fused_vio_frame_step and the deferred-cadence (ba_every>1)
    multi-sequence DP step, which runs the window-BA solve on a
    scan-uniform schedule outside the vmapped per-sequence step."""
    i0, i1, t_img, a, g, it, iv = xs
    vio = vimotion.imu_feed_batch(vcfg, vio, a, g, it, iv)
    ff = vimotion.get_frame_state(vio, t_img, T_i_c)
    fe = tracker.apply_correction_(fe, corr)             # backend feedback
    cv = se3m.compose(se3m.exp(fe.velocity), fe.T_prev)
    prior = jax.tree.map(lambda x, y: jnp.where(ff.ok, x, y),
                         ff.T_c_w, cv)
    fe, out = tracker.track_frame(fcfg, cam, fe, i0, i1,
                                  prior_T=prior, use_prior=True)
    # Roll/pitch feedforward blend (weight cfg.vio.rp_blend) applied to
    # the vision pose, rebasing the tracker's pose chain onto it.
    T_blend = vimotion.rp_compensate_pose(vcfg, out.T_c_w, ff.q_w_i, T_i_c)
    do_blend = ff.ok & (out.status == tracker.STATUS_TRACKING)
    T_out = jax.tree.map(lambda x, y: jnp.where(do_blend, x, y),
                         T_blend, out.T_c_w)
    fe = tracker.rebase_pose_(fe, fe.frame_id - 1, T_out, do_blend)
    out = out._replace(T_c_w=T_out)
    # Vision → IMU bias feedback; independent of the backend tail, so it
    # runs here (before BA) with identical semantics to the stepwise path.
    vio = jax.lax.cond(
        out.status == tracker.STATUS_TRACKING,
        lambda v: vimotion.correction_from_vision(vcfg, v, t_img, T_out,
                                                  T_i_c),
        lambda v: v, vio)
    return fe, vio, out


def _fused_vio_frame_step(fcfg, bcfg, vcfg, cam, T_i_c, null, carry, xs):
    """One frame of the fused VIO pipeline (IMU propagation → feedforward
    prior → track → RP blend → keyframe BA → bias feedback).  Shared by
    _chunk_fused_vio and the (S,)-batched multi-sequence DP variant."""
    fe, ba, vio, corr = carry
    fe, vio, out = _vio_frame_core(fcfg, vcfg, cam, T_i_c, fe, vio, corr, xs)
    ba, pkt, corr_new, cost = _ba_tail(fcfg, bcfg, cam, null, fe, ba, out)
    return (fe, ba, vio, corr_new), (out, pkt, corr_new, cost)


def pack_imu_frames(imu_accs, imu_gyros, imu_ts, pad: int = 16):
    """Pack per-frame IMU sample lists into fixed-shape (T, pad, ·) arrays
    with validity masks for _chunk_fused_vio.

    Raises on frames with more than `pad` samples — silently dropping IMU
    data would make the chunked path diverge from stepwise feed_imu (which
    pads to any size).  process_frames_vio pre-drains the only legitimately
    oversized window (the first frame's pre-camera IMU history) before
    packing.
    """
    T = len(imu_ts)
    acc = np.zeros((T, pad, 3), np.float32)
    gyro = np.zeros((T, pad, 3), np.float32)
    t = np.zeros((T, pad), np.float32)
    valid = np.zeros((T, pad), bool)
    for i in range(T):
        n = len(imu_ts[i])
        if n > pad:
            raise ValueError(
                f"frame {i} carries {n} IMU samples > imu_pad={pad}; raise "
                f"imu_pad (IMU-rate/frame-rate ratio exceeds the slot count)")
        acc[i, :n] = np.asarray(imu_accs[i], np.float32)
        gyro[i, :n] = np.asarray(imu_gyros[i], np.float32)
        t[i, :n] = np.asarray(imu_ts[i], np.float32)
        valid[i, :n] = True
    return acc, gyro, t, valid


class SlamSystem:
    """Stereo(+IMU) SLAM engine instance for one sequence."""

    def __init__(self, cfg: SystemConfig, cam: StereoCamera,
                 T_i_c: Optional[SE3] = None, use_imu: bool = False,
                 use_loop: bool = False, output_sparse_map: bool = False,
                 loop_device=None, pipelined: bool = False):
        self.cfg = cfg
        self.cam = cam
        self.use_imu = use_imu
        self.T_i_c = T_i_c if T_i_c is not None else se3m.identity()
        self.fe_state = tracker.init_state(cfg.frontend)
        self.ba_state = window_ba.empty(cfg.backend)
        self.vio_state = vimotion.init_state(cfg.vio)
        self.pending_corr: Optional[window_ba.Correction] = None
        self._frames_processed = 0      # host mirror of fe_state.frame_id
        self.keyframes: list = []       # host log of keyframe packets (for loop closing)
        self.trajectory: list = []      # (frame_id, t_img, q, t)
        self.ba_costs: list = []
        self.loop_closer = None
        self._pending_gate = None   # deferred loop-gate handle (chunk replay)
        self._pending_verify = None  # deferred verification handle
        # Software-pipelined chunk replay (double-buffering): process_frames
        # dispatches chunk N+1's fused program BEFORE resolving chunk N's
        # packed fetch, so every host round trip and all loop-node host
        # bookkeeping overlap the device's execution of the next chunk —
        # the single-chip equivalent of the reference's concurrently running
        # nodelets (tracking thread vo_tracking.cpp:396-482; free-running
        # loop threads vo_loopclosing.cpp:181-518).  Results then return one
        # chunk late; call flush() after the last chunk.
        self.pipelined = pipelined
        self._inflight = None
        if use_loop:
            from ..loop.loop_closing import LoopCloser

            # loop_device: place the WHOLE loop node (store + ingest + gate
            # + verify + PGO) on a second device — the reference's loop
            # nodelet runs on spare CPU cores and never taxes tracking
            # (vo_loopclosing.cpp:1106-1118); async dispatch to another
            # device is the equivalent here.
            self.loop_closer = LoopCloser(cfg.loop, cam,
                                          depth_mode=cfg.frontend.depth_mode,
                                          device=loop_device,
                                          pgo_device=loop_device)
        # The reference's `output_sparse_map` YAML flag: accumulate BA-
        # corrected landmarks into a voxel-downsampled map cloud
        # (vo_localmap.cpp:367-377).
        self.sparse_map = None
        if output_sparse_map:
            from ..viz.cloud import SparseMapRecorder

            self.sparse_map = SparseMapRecorder()

    # ------------------------------------------------------------------ IMU
    def feed_imu(self, acc, gyro, t):
        """Feed a batch of IMU samples (arrays (B,3), (B,3), (B,)).

        Batches are padded to the next multiple of 16 with a validity mask so
        jitter in per-frame IMU counts doesn't trigger recompiles."""
        b = len(t)
        if b == 0:
            return
        pad = (-b) % 16
        acc = np.concatenate([np.asarray(acc, np.float32), np.zeros((pad, 3), np.float32)])
        gyro = np.concatenate([np.asarray(gyro, np.float32), np.zeros((pad, 3), np.float32)])
        tt = np.concatenate([np.asarray(t, np.float32), np.zeros(pad, np.float32)])
        valid = np.arange(b + pad) < b
        self.vio_state = vimotion.imu_feed_batch(
            self.cfg.vio, self.vio_state,
            jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(tt),
            jnp.asarray(valid),
        )

    # ---------------------------------------------------------------- frame
    def process_frame(self, img0, img1, t_img: float = 0.0):
        cfg = self.cfg

        if self._inflight is not None:
            # Interleaving stepwise frames with pipelined chunks: resolve
            # the in-flight chunk first so host bookkeeping (trajectory,
            # keyframe log, loop ingest) stays stream-ordered.
            inflight, self._inflight = self._inflight, None
            self._finish_chunk(*inflight)

        # Apply the previous keyframe's BA correction (feedback loop).
        if self.pending_corr is not None:
            self.fe_state = tracker.apply_correction(self.fe_state, self.pending_corr)
            self.pending_corr = None

        prior = None
        use_prior = False
        ff = None
        if self.use_imu:
            ff = vimotion.get_frame_state(self.vio_state, jnp.asarray(t_img), self.T_i_c)
            if bool(ff.ok):
                prior = ff.T_c_w
                use_prior = True

        self.fe_state, out = tracker.track_frame(
            cfg.frontend, self.cam, self.fe_state,
            jnp.asarray(img0), jnp.asarray(img1),
            prior_T=prior, use_prior=use_prior,
        )

        if use_prior and bool(out.status == tracker.STATUS_TRACKING):
            # Roll/pitch feedforward compensation (f2f_tracking.cpp:251-254):
            # blend the IMU attitude's gravity-observable components into the
            # vision pose and rebase the tracker's pose chain onto it.
            T_blend = vimotion.rp_compensate_pose(cfg.vio, out.T_c_w,
                                                  ff.q_w_i, self.T_i_c)
            self.fe_state = tracker.rebase_pose(
                self.fe_state,
                jnp.asarray(self._frames_processed, jnp.int32),
                T_blend, jnp.asarray(True))
            out = out._replace(T_c_w=T_blend)

        if bool(out.reset_backend):
            # KFMSG_CMD_RESET_LM: wipe the window (vo_localmap.cpp:89-98).
            self.ba_state = window_ba.reset(cfg.backend, self.ba_state)

        if bool(out.is_keyframe):
            pkt = tracker.make_keyframe_packet(self.fe_state, out)
            self.ba_state = window_ba.add_keyframe(cfg.backend, self.ba_state, pkt)
            res = window_ba.optimize(cfg.backend, self.cam, self.ba_state)
            self.ba_state = res.state
            self.pending_corr = res.correction   # applied next frame (async)
            if self.sparse_map is not None and bool(res.correction.valid):
                self.sparse_map.add_correction(
                    res.correction.lm_id, res.correction.lm_pw,
                    res.correction.lm_mask)
            self.keyframes.append(pkt)
            self.ba_costs.append(res.cost)
            if self.loop_closer is not None:
                # Loop node ingests the same keyframe stream (/vo_kf).
                k = self.loop_closer.add_keyframe(img0, img1, out.T_c_w,
                                                  int(pkt.frame_id))
                if self.loop_closer.detect_loop(k) is not None:
                    self.loop_closer.optimize_graph()

        if self.use_imu and bool(out.status == tracker.STATUS_TRACKING):
            # Vision → IMU feedback (bias estimation + state rebase).
            self.vio_state = vimotion.correction_from_vision(
                cfg.vio, self.vio_state, jnp.asarray(t_img), out.T_c_w, self.T_i_c
            )

        self.trajectory.append(
            (self._frames_processed, t_img,
             np.asarray(out.T_c_w.q), np.asarray(out.T_c_w.t))
        )
        self._frames_processed += 1
        return out

    # ---------------------------------------------------------- chunk replay
    def process_frames(self, imgs0, imgs1, ts=None):
        """Dataset-replay fast path: frontend tracking AND per-keyframe
        window BA for a whole chunk run as ONE device program (_chunk_fused),
        followed by a SINGLE packed device fetch for host bookkeeping.

        ~8x the stepwise throughput (no per-frame dispatch; no per-keyframe
        BA dispatch).  BA feedback is applied on the frame after each
        keyframe inside the chunk — the same one-keyframe-late timing as the
        stepwise path and the reference (f2f_tracking.cpp:189-219).  IMU
        feedforward is not available inside a chunk, so this path suits the
        no-IMU configs (e.g. KITTI) or post-processing runs.

        Args:
          imgs0/imgs1: (T, H, W) stacked frames; ts optional (T,) times.
        Returns the stacked FrameOutput (host numpy pytree).  In pipelined
        mode the PREVIOUS chunk's outputs are returned (None on the first
        call); call flush() after the last chunk.
        """
        cfg = self.cfg
        corr0 = (self.pending_corr if self.pending_corr is not None
                 else window_ba.null_correction(cfg.backend))
        imgs0 = jnp.asarray(imgs0)
        imgs1 = jnp.asarray(imgs1)
        T = imgs0.shape[0]
        self.fe_state, self.ba_state, self.pending_corr, ys = _chunk_fused(
            cfg.frontend, cfg.backend, self.cam,
            self.fe_state, self.ba_state, corr0, imgs0, imgs1)
        return self._after_dispatch(ys, imgs0, imgs1, ts, T)

    def process_frames_vio(self, imgs0, imgs1, ts, imu_acc, imu_gyro, imu_t,
                           imu_pad: int = 16):
        """Chunked VIO replay (EuRoC mode): the whole chunk — IMU
        propagation, feedforward pose priors, tracking, RP compensation,
        keyframe window BA, correction feedback, and vision→IMU bias
        feedback — runs as ONE device program (_chunk_fused_vio).

        Args:
          imgs0/imgs1: (T, H, W) stacked rectified stereo frames.
          ts: (T,) image timestamps (seconds, same clock as imu_t).
          imu_acc/imu_gyro/imu_t: length-T lists of per-frame IMU sample
            arrays (the samples since the previous frame, ENU-remapped).
          imu_pad: fixed per-frame IMU slot count (static shape).
        Returns the stacked FrameOutput (host numpy pytree).
        """
        cfg = self.cfg
        corr0 = (self.pending_corr if self.pending_corr is not None
                 else window_ba.null_correction(cfg.backend))
        imgs0 = jnp.asarray(imgs0)
        imgs1 = jnp.asarray(imgs1)
        T = imgs0.shape[0]
        # The first frame's window may carry the whole pre-camera IMU
        # history (EuRoC's imu0 starts seconds before cam0) — feed all but
        # the newest imu_pad samples through the stepwise path first; they
        # precede every frame in the chunk, so ordering is preserved.
        n0 = len(imu_t[0])
        if n0 > imu_pad:
            k = n0 - imu_pad
            self.feed_imu(np.asarray(imu_acc[0])[:k],
                          np.asarray(imu_gyro[0])[:k],
                          np.asarray(imu_t[0])[:k])
            imu_acc = [np.asarray(imu_acc[0])[k:]] + list(imu_acc[1:])
            imu_gyro = [np.asarray(imu_gyro[0])[k:]] + list(imu_gyro[1:])
            imu_t = [np.asarray(imu_t[0])[k:]] + list(imu_t[1:])
        acc, gyro, it, iv = pack_imu_frames(imu_acc, imu_gyro, imu_t, imu_pad)
        (self.fe_state, self.ba_state, self.vio_state, self.pending_corr,
         ys) = _chunk_fused_vio(
            cfg.frontend, cfg.backend, cfg.vio, self.cam, self.T_i_c,
            self.fe_state, self.ba_state, self.vio_state, corr0,
            imgs0, imgs1, jnp.asarray(np.asarray(ts, np.float32)),
            jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(it),
            jnp.asarray(iv))
        return self._after_dispatch(ys, imgs0, imgs1, ts, T)

    def _after_dispatch(self, ys, imgs0, imgs1, ts, T):
        """Route a freshly dispatched chunk: synchronous mode finishes it
        now; pipelined mode stashes it in flight and finishes the PREVIOUS
        chunk instead (whose device work has already completed underneath
        the just-dispatched program), returning that chunk's outputs — or
        None on the very first call.

        The packed-output program is dispatched HERE, not at finish time:
        on the serial device queue it must precede the next chunk's fused
        program or the finish-time fetch would wait out chunk N+1 too."""
        outs, pkts, corrs, costs = ys
        packed_dev = _pack_outputs(outs, costs, corrs.valid)
        if not self.pipelined:
            return self._finish_chunk(packed_dev, ys, imgs0, imgs1, ts, T)
        prev = self._inflight
        self._inflight = (packed_dev, ys, imgs0, imgs1, ts, T)
        return self._finish_chunk(*prev) if prev is not None else None

    def _finish_chunk(self, packed_dev, ys, imgs0, imgs1, ts, T):
        """Host bookkeeping after a fused chunk program: ONE packed device
        fetch, then keyframe/trajectory/loop-closing handling.

        The loop node's candidate-gate rows AND verification statistics are
        resolved ONE CHUNK LATE each: chunk N dispatches its gate program
        asynchronously; chunk N+1's finish bundles the (M, 4) row fetch
        into its own packed-output device_get, makes the host gate decision
        and dispatches verification; chunk N+2's finish bundles the stats
        fetch the same way and runs the accept gates + (dispatch-only) PGO.
        The steady-state loop path therefore costs zero extra host round
        trips and never blocks the frame path (the reference's free-running
        search + pgo threads lag ingest the same way, vo_loopclosing.cpp:
        393-518).  Call flush_loop() after the last chunk to resolve the
        final batches."""
        outs, pkts, corrs, costs = ys
        prev_gate = self._pending_gate
        prev_verify = self._pending_verify
        prev_rows = None
        lc = self.loop_closer
        pending_dev = lc.pending_rows(prev_gate) if lc is not None else None
        verify_dev = (lc.pending_verify_arrays(prev_verify)
                      if lc is not None else None)
        fetched = jax.device_get((packed_dev, pending_dev, verify_dev))
        packed, prev_rows, verify_stats = fetched
        packed = np.asarray(packed)
        if lc is not None and prev_verify is not None:
            self._pending_verify = None
            if lc.resolve_verify(prev_verify, verify_stats):
                lc.optimize_graph()          # dispatch-only: no fetch inside
        if lc is not None and prev_gate is not None:
            self._pending_gate = None
            handle = lc.dispatch_verify(prev_gate, prev_rows)
            if handle is not None and handle[0] == "done":
                if handle[1]:
                    lc.optimize_graph()      # mesh-sharded sync path
            else:
                self._pending_verify = handle
        outs_np = _unpack_outputs(packed)
        first_fid = self._frames_processed
        self._frames_processed += T
        kf_idx = []
        for i in range(T):
            if bool(outs_np.is_keyframe[i]):
                kf_idx.append(i)
                pkt = _slice_tree(pkts, jnp.asarray(i, jnp.int32))
                self.keyframes.append(pkt)
                self.ba_costs.append(packed[i, 12])
                if self.sparse_map is not None and packed[i, 13] > 0.5:
                    corr = _slice_tree(corrs, jnp.asarray(i, jnp.int32))
                    self.sparse_map.add_correction(
                        corr.lm_id, corr.lm_pw, corr.lm_mask)
            self.trajectory.append(
                (first_fid + i, float(ts[i]) if ts is not None else 0.0,
                 outs_np.T_c_w.q[i], outs_np.T_c_w.t[i]))
        new_ks = []
        if self.loop_closer is not None and kf_idx:
            # Whole-chunk loop-node ingest: one fused ingest+scatter program
            # + one batched BoW program for ALL the chunk's keyframes, not
            # ~5 dispatches per keyframe.
            new_ks = self.loop_closer.add_keyframes_batch(
                imgs0, imgs1, kf_idx,
                outs_np.T_c_w.q[kf_idx], outs_np.T_c_w.t[kf_idx],
                [first_fid + i for i in kf_idx])
        if self.loop_closer is not None and new_ks:
            # Dispatch the batched candidate gate; the decision resolves at
            # the next chunk's bundled fetch (see docstring above).
            self._pending_gate = self.loop_closer.gate_candidates(new_ks)
        return outs_np

    def flush_loop(self):
        """Resolve the deferred loop-node verification and candidate gate
        from the last chunks — call once after replay ends (chunked mode
        only; flush() calls this for the pipelined mode)."""
        lc = self.loop_closer
        if lc is None:
            return
        pending_v = self._pending_verify
        self._pending_verify = None
        if pending_v is not None and lc.resolve_verify(pending_v):
            lc.optimize_graph()
        pending = self._pending_gate
        self._pending_gate = None
        if pending is not None and lc.decide_loops(pending):
            lc.optimize_graph()

    def flush(self):
        """Drain the pipeline: finish the in-flight chunk (pipelined mode)
        and resolve the loop node's deferred batches.  Returns the last
        chunk's FrameOutput (or None if nothing was in flight)."""
        out = None
        if self._inflight is not None:
            inflight, self._inflight = self._inflight, None
            out = self._finish_chunk(*inflight)
        self.flush_loop()
        return out

    # ------------------------------------------------------------- exports
    def trajectory_cam_centers(self, loop_corrected: bool = False):
        """(N, 3) camera centres C = -Rᵀ t in world frame.

        With loop_corrected=True the loop-closer's map→odom drift transform
        is applied (the reference's drift-corrected republished path)."""
        from ..geometry import so3
        out = []
        for (_, _, q, t) in self.trajectory:
            T = SE3(jnp.asarray(q), jnp.asarray(t))
            if loop_corrected and self.loop_closer is not None:
                T = self.loop_closer.corrected_pose(T)
            R = np.asarray(so3.to_matrix(T.q))
            out.append(-R.T @ np.asarray(T.t))
        return np.asarray(out)
