"""Multi-sequence data parallelism WITH the loop-closing stage.

The reference's default launch loads ALL THREE nodelets for every run —
tracking, local-map BA, loop closing (/root/reference/flvis.xml:1-23;
launch/flvis_euroc_mav.launch:29) — so the production "all EuRoC runs
data-parallel" workload must carry a loop node per sequence, not just
tracking + BA.

Design: the compute-heavy chunk (tracking + window BA + feedback [+ VIO])
stays ONE batched device program over the (S, T, H, W) stacks
(multiseq.system_chunk_batch[_vio][_sharded]); the loop stage is
host-orchestrated per sequence over the same batched ingest/gate/verify
programs the single-sequence LoopCloser uses (stores stay per-sequence,
matching the reference's per-run keyframe database — vo_loopclosing.cpp:
99-112), with the deferred-resolution contract of the pipelined runner:

  chunk N   : ingest chunk N's keyframes; dispatch the candidate gate
  chunk N+1 : the chunk's ONE bundled fetch carries the gate rows →
              host decision → dispatch geometric verification
  chunk N+2 : the bundled fetch carries the verify stats → accept gates →
              pose-graph optimization (dispatch-only)

so the steady-state loop path adds ZERO blocking host round trips beyond
the chunk's single packed fetch — the reference's free-running loop threads
lag ingest the same way (vo_loopclosing.cpp:393-518).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SystemConfig
from ..geometry import se3 as se3m
from ..geometry.camera import StereoCamera
from ..geometry.se3 import SE3
from ..loop.loop_closing import LoopCloser
from ..pipeline import runner as runner_m
from . import multiseq


@jax.jit
def _pack_outputs_batch(outs):
    """(S, T)-leading FrameOutput → (S, T, 12) packed array: ONE device
    fetch per chunk for all sequences' host bookkeeping."""
    return jax.vmap(runner_m._pack_outputs.__wrapped__)(outs)


class MultiSeqSlam:
    """S independent SLAM runs: one batched chunk program + S loop nodes.

    Args:
      cfg: SystemConfig shared by every sequence (the reference launches
        every run with the same YAML).
      cam: StereoCamera shared by all sequences (per-seq intrinsics can be
        added by passing a pre-batched pytree as `cams`).
      num_seqs: S.
      use_imu: run the full VIO loop per sequence (process_chunk_vio).
      use_loop: attach a LoopCloser per sequence.
      mesh: optional jax Mesh with a `seq` axis — the chunk program then
        runs under shard_map with zero collectives (multiseq module note)
        and states/images are placed seq-sharded.
      ba_every: window-BA cadence for the batched solve (multiseq note).
      pipelined: double-buffered chunk replay, as SlamSystem(pipelined=True):
        chunk N+1's batched program dispatches before chunk N's packed
        fetch resolves, hiding the per-sequence loop-node dispatches
        (2 programs x S sequences per chunk) behind the next chunk's
        device time.  process_chunk* then returns the PREVIOUS chunk's
        packed outputs (None on the first call); call flush() at the end.
    """

    def __init__(self, cfg: SystemConfig, cam: StereoCamera, num_seqs: int,
                 use_imu: bool = False, use_loop: bool = True, mesh=None,
                 ba_every: int = 1, T_i_c: Optional[SE3] = None,
                 cams=None, pipelined: bool = False):
        self.cfg = cfg
        self.cam = cam
        self.S = num_seqs
        self.use_imu = use_imu
        self.mesh = mesh
        self.ba_every = ba_every
        bc = lambda a: jnp.broadcast_to(
            jnp.asarray(a), (num_seqs,) + jnp.shape(jnp.asarray(a)))
        self.cams = cams if cams is not None else jax.tree.map(bc, cam)
        one_T = T_i_c if T_i_c is not None else se3m.identity()
        self.T_i_cs = jax.tree.map(bc, one_T)
        states = multiseq.init_system_states(
            cfg.frontend, cfg.backend, num_seqs, mesh,
            vcfg=cfg.vio if use_imu else None)
        if use_imu:
            self.fe, self.ba, self.corr, self.vio = states
        else:
            self.fe, self.ba, self.corr = states
            self.vio = None
        if mesh is not None:
            self.cams = multiseq.shard_batch(mesh, self.cams)
            self.T_i_cs = multiseq.shard_batch(mesh, self.T_i_cs)
        self.loopers: list[LoopCloser | None] = [
            LoopCloser(cfg.loop, cam, depth_mode=cfg.frontend.depth_mode)
            if use_loop else None for _ in range(num_seqs)]
        self._pending_gate: list = [None] * num_seqs
        self._pending_verify: list = [None] * num_seqs
        self._frames = 0
        self.trajectories: list[list] = [[] for _ in range(num_seqs)]
        self.pipelined = pipelined
        self._inflight = None

    # ---------------------------------------------------------------- chunks
    def process_chunk(self, imgs0, imgs1, ts=None):
        """One (S, T, H, W) chunk through the batched tracking+BA program,
        then the per-sequence loop stage.  Returns the (S, T, 12) packed
        host outputs (columns as runner._pack_outputs)."""
        imgs0 = jnp.asarray(imgs0)
        imgs1 = jnp.asarray(imgs1)
        if self.mesh is not None:
            self.fe, self.ba, self.corr, outs, _ = \
                multiseq.system_chunk_batch_sharded(
                    self.mesh, self.cfg.frontend, self.cfg.backend,
                    self.cams, self.fe, self.ba, self.corr, imgs0, imgs1,
                    ba_every=self.ba_every)
        else:
            self.fe, self.ba, self.corr, outs, _ = \
                multiseq.system_chunk_batch(
                    self.cfg.frontend, self.cfg.backend, self.cams,
                    self.fe, self.ba, self.corr, imgs0, imgs1,
                    ba_every=self.ba_every)
        return self._after_dispatch(outs, imgs0, imgs1, ts)

    def process_chunk_vio(self, imgs0, imgs1, ts, acc, gyro, imu_t,
                          imu_valid):
        """VIO variant: (S, T) image-time array plus (S, T, P, ·) packed
        per-frame IMU batches (runner.pack_imu_frames per sequence)."""
        imgs0 = jnp.asarray(imgs0)
        imgs1 = jnp.asarray(imgs1)
        args = (self.cams, self.T_i_cs, self.fe, self.ba, self.vio,
                self.corr, imgs0, imgs1, jnp.asarray(ts), jnp.asarray(acc),
                jnp.asarray(gyro), jnp.asarray(imu_t),
                jnp.asarray(imu_valid))
        if self.mesh is not None:
            (self.fe, self.ba, self.vio, self.corr, outs, _) = \
                multiseq.system_chunk_batch_vio_sharded(
                    self.mesh, self.cfg.frontend, self.cfg.backend,
                    self.cfg.vio, *args, ba_every=self.ba_every)
        else:
            (self.fe, self.ba, self.vio, self.corr, outs, _) = \
                multiseq.system_chunk_batch_vio(
                    self.cfg.frontend, self.cfg.backend, self.cfg.vio,
                    *args, ba_every=self.ba_every)
        return self._after_dispatch(outs, imgs0, imgs1, ts)

    def _after_dispatch(self, outs, imgs0, imgs1, ts):
        """Synchronous mode finishes the chunk now; pipelined mode stashes
        it and finishes the PREVIOUS chunk (see SlamSystem._after_dispatch:
        the pack program must dispatch before the next chunk's program)."""
        packed_dev = _pack_outputs_batch(outs)
        if not self.pipelined:
            return self._finish(packed_dev, imgs0, imgs1, ts)
        prev = self._inflight
        self._inflight = (packed_dev, imgs0, imgs1, ts)
        return self._finish(*prev) if prev is not None else None

    # ----------------------------------------------------------- loop stage
    def _finish(self, packed_dev, imgs0, imgs1, ts):
        S, T = imgs0.shape[0], imgs0.shape[1]
        gate_devs = [None if lc is None else lc.pending_rows(g)
                     for lc, g in zip(self.loopers, self._pending_gate)]
        verify_devs = [None if lc is None else lc.pending_verify_arrays(v)
                       for lc, v in zip(self.loopers, self._pending_verify)]
        # Bundle ts into the same device_get when it lives on device (the
        # VIO path ships it as a jnp array): a separate np.asarray(ts)
        # would cost one extra host round trip per chunk.
        ts_dev = ts if isinstance(ts, jax.Array) else None
        packed, gate_rows, verify_stats, ts_fetched = jax.device_get(
            (packed_dev, gate_devs, verify_devs, ts_dev))
        if ts_fetched is not None:
            ts = ts_fetched
        packed = np.asarray(packed)
        for s in range(S):
            lc = self.loopers[s]
            if lc is None:
                continue
            pv, self._pending_verify[s] = self._pending_verify[s], None
            if pv is not None and lc.resolve_verify(pv, verify_stats[s]):
                lc.optimize_graph()          # dispatch-only
            pg, self._pending_gate[s] = self._pending_gate[s], None
            if pg is not None:
                h = lc.dispatch_verify(pg, gate_rows[s])
                if h is not None and h[0] == "done":
                    if h[1]:
                        lc.optimize_graph()
                else:
                    self._pending_verify[s] = h
        first = self._frames
        self._frames += T
        ts_np = None if ts is None else np.asarray(ts, np.float64)
        for s in range(S):
            for i in range(T):
                self.trajectories[s].append(
                    (first + i,
                     float(ts_np[s, i]) if ts_np is not None else 0.0,
                     packed[s, i, 5:9].copy(), packed[s, i, 9:12].copy()))
            lc = self.loopers[s]
            if lc is None:
                continue
            kf_idx = [i for i in range(T) if packed[s, i, 0] > 0.5]
            if kf_idx:
                new_ks = lc.add_keyframes_batch(
                    imgs0[s], imgs1[s], kf_idx,
                    packed[s, kf_idx, 5:9], packed[s, kf_idx, 9:12],
                    [first + i for i in kf_idx])
                if new_ks:
                    self._pending_gate[s] = lc.gate_candidates(new_ks)
        return packed

    def flush(self):
        """Drain the in-flight chunk (pipelined mode) and every sequence's
        deferred verification + candidate gate (call once after replay
        ends).  Returns the last chunk's packed outputs (or None)."""
        out = None
        if self._inflight is not None:
            inflight, self._inflight = self._inflight, None
            out = self._finish(*inflight)
        for s in range(self.S):
            lc = self.loopers[s]
            if lc is None:
                continue
            pv, self._pending_verify[s] = self._pending_verify[s], None
            if pv is not None and lc.resolve_verify(pv):
                lc.optimize_graph()
            pg, self._pending_gate[s] = self._pending_gate[s], None
            if pg is not None and lc.decide_loops(pg):
                lc.optimize_graph()
        return out

    # -------------------------------------------------------------- exports
    def trajectory_cam_centers(self, s: int, loop_corrected: bool = False):
        """(N, 3) camera centres of sequence s (optionally drift-corrected
        through that sequence's loop node)."""
        from ..geometry import so3

        lc = self.loopers[s]
        out = []
        for (_, _, q, t) in self.trajectories[s]:
            T = SE3(jnp.asarray(q, jnp.float32), jnp.asarray(t, jnp.float32))
            if loop_corrected and lc is not None:
                T = lc.corrected_pose(T)
            R = np.asarray(so3.to_matrix(T.q))
            out.append(-R.T @ np.asarray(T.t))
        return np.asarray(out)
