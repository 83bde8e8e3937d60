"""Cross-device pipeline overlap: frontend and backend BA on separate devices.

The reference runs tracking and the sliding-window BA as separate ROS
nodelets whose threads overlap — tracking is never blocked by BA, and
corrections arrive one keyframe late (f2f_tracking.cpp:189-219,
vo_localmap.cpp:87-380).  Here the equivalent needs no threads: JAX's
async dispatch IS the pipeline.  The tracker state lives on the frontend
device and the BA window on the backend device; at a keyframe the packet is
device_put to the backend and the 12+8 Schur optimize is DISPATCHED
there — the host immediately continues dispatching the next frames on
the frontend device while the backend device solves, and the
resulting Correction is transferred back and applied one frame later.
Identical numerics to the single-device stepwise path (same programs, same
one-keyframe-late feedback), with the BA latency hidden behind the next
frame's tracking.

For whole-sequence replay on ONE chip, the fused chunk programs
(pipeline.runner._chunk_fused*) remain the faster mode — this module is the
multi-chip LIVE-pipeline arrangement (one dispatch per frame).  The loop
closer's PGO can be placed on a third device via LoopCloser(pgo_device=...).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..backend import window_ba
from ..config import SystemConfig
from ..frontend import tracker
from ..geometry.camera import StereoCamera
from ..geometry.se3 import SE3


@functools.partial(jax.jit, static_argnames=("bcfg",))
def _backend_step(bcfg, cam, ba_state, pkt, is_kf, reset):
    """The backend chip's per-frame program: conditional window reset +
    conditional add_keyframe/optimize, dispatched UNCONDITIONALLY every
    frame so the keyframe decision never has to cross to the host.  On
    non-keyframe frames the lax.cond skips the solve and returns a
    valid=False Correction."""
    ba = jax.lax.cond(reset, lambda b: window_ba.reset(bcfg, b),
                      lambda b: b, ba_state)

    def do(b):
        b = window_ba.add_keyframe(bcfg, b, pkt)
        res = window_ba.optimize(bcfg, cam, b)
        return res.state, res.correction, res.cost

    def no(b):
        return b, window_ba.null_correction(bcfg), jnp.asarray(0.0,
                                                               jnp.float32)

    return jax.lax.cond(is_kf, do, no, ba)


@jax.jit
def _pack_row(out: tracker.FrameOutput):
    """One (12,) row [is_kf, reset, status, n_inl, err, q, t] — the ONLY
    array the host fetches per frame."""
    return jnp.concatenate([
        jnp.stack([out.is_keyframe.astype(jnp.float32),
                   out.reset_backend.astype(jnp.float32),
                   out.status.astype(jnp.float32),
                   out.num_inliers.astype(jnp.float32),
                   out.mean_reproj_err]),
        out.T_c_w.q, out.T_c_w.t])


class OverlappedPipeline:
    """Two-device frontend/backend pipeline (stepwise, per-frame).

    Host-synchronization contract: exactly ONE device fetch per frame (the
    packed frontend row, via _fetch — `fetch_count` counts them): fetching
    result-dependent scalars per frame (`bool(out.is_keyframe)` etc.) would
    serialize the two devices it exists to overlap, so the backend program
    is dispatched unconditionally under lax.cond and the host never waits
    on the backend device at all (BA costs stay device handles until
    `ba_costs()` is called)."""

    def __init__(self, cfg: SystemConfig, cam: StereoCamera,
                 fe_device=None, ba_device=None):
        devs = jax.devices()
        self.fe_dev = fe_device if fe_device is not None else devs[0]
        self.ba_dev = ba_device if ba_device is not None else \
            devs[1 % len(devs)]
        self.cfg = cfg
        self.cam_fe = jax.device_put(cam, self.fe_dev)
        self.cam_ba = jax.device_put(cam, self.ba_dev)
        self.fe_state = jax.device_put(tracker.init_state(cfg.frontend),
                                       self.fe_dev)
        self.ba_state = jax.device_put(window_ba.empty(cfg.backend),
                                       self.ba_dev)
        self.pending_corr: Optional[window_ba.Correction] = None
        self.trajectory: list = []
        self._ba_cost_handles: list = []
        self._kf_flags: list = []
        self._frames = 0
        self.fetch_count = 0        # host device-fetches issued (test hook)

    def _fetch(self, x) -> np.ndarray:
        """The single funnel for host←device transfers in the frame loop."""
        self.fetch_count += 1
        return np.asarray(jax.device_get(x))

    def process_frame(self, img0, img1):
        cfg = self.cfg
        if self.pending_corr is not None:
            # One-keyframe-late feedback: transfer the backend's Correction
            # to the frontend chip and rebase (f2f_tracking.cpp:189-219).
            # apply_correction cond-gates on corr.valid, so the null
            # corrections of non-keyframe frames cost nothing.
            corr = jax.device_put(self.pending_corr, self.fe_dev)
            self.fe_state = tracker.apply_correction(self.fe_state, corr)
            self.pending_corr = None

        self.fe_state, out = tracker.track_frame(
            cfg.frontend, self.cam_fe, self.fe_state,
            jax.device_put(jnp.asarray(img0), self.fe_dev),
            jax.device_put(jnp.asarray(img1), self.fe_dev))

        # Backend dispatch EVERY frame — the keyframe decision stays on
        # device (lax.cond in _backend_step); the packet/flag transfer and
        # the solve are async, the host continues immediately.
        pkt = tracker.make_keyframe_packet(self.fe_state, out)
        pkt_b, is_kf_b, reset_b = jax.device_put(
            (pkt, out.is_keyframe, out.reset_backend), self.ba_dev)
        self.ba_state, self.pending_corr, cost = _backend_step(
            cfg.backend, self.cam_ba, self.ba_state, pkt_b, is_kf_b,
            reset_b)
        self._ba_cost_handles.append(cost)

        # The frame's ONE host fetch: the packed frontend row.
        row = self._fetch(_pack_row(out))
        self._kf_flags.append(bool(row[0] > 0.5))
        self.trajectory.append((self._frames, row[5:9], row[9:12]))
        self._frames += 1
        return tracker.FrameOutput(
            T_c_w=SE3(row[5:9], row[9:12]),
            is_keyframe=row[0] > 0.5, reset_backend=row[1] > 0.5,
            num_inliers=int(row[3]), mean_reproj_err=row[4],
            status=int(row[2]))

    def ba_costs(self) -> list:
        """BA costs of keyframe frames (fetched HERE, off the frame loop;
        non-keyframe rows — where the cond skipped the solve — drop out)."""
        vals = jax.device_get(self._ba_cost_handles)
        return [float(v) for v, k in zip(vals, self._kf_flags) if k]
