"""Multi-sequence data parallelism: shard independent SLAM runs over devices.

The reference processes one rosbag per process (SURVEY.md §2.3); here the
scaling story starts with the embarrassingly-parallel axis — "all 11
EuRoC runs sharded across devices" (BASELINE.json north star).
A batch of independent TrackerStates is laid out with a leading `seq` axis
sharded over the device mesh; the per-frame step is the vmapped tracker,
jitted with NamedSharding constraints so XLA keeps every sequence resident
on its own device with zero cross-device traffic in steady state.

This module is deliberately thin: the tracker itself is already pure and
fixed-shape, so data parallelism is vmap + sharding annotations — no
NCCL-style replication machinery to port.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..backend import window_ba
from ..config import BackendConfig, FrontendConfig, VioConfig
from ..frontend import tracker
from ..geometry.camera import StereoCamera
from ..pipeline import runner as runner_m
from ..vio import vimotion


def make_mesh(n_devices: int | None = None, axis: str = "seq") -> Mesh:
    devs = jax.devices()[: n_devices or len(jax.devices())]
    # Auto axis type: classic GSPMD sharding propagation.  The default
    # Explicit type threads shardings through abstract values, which breaks
    # vmap-of-lax.cond (the tracker's state-machine dispatch).
    return jax.make_mesh(
        (len(devs),), (axis,), devices=devs,
        axis_types=(jax.sharding.AxisType.Auto,),
    )


def init_states(cfg: FrontendConfig, num_seqs: int, mesh: Mesh | None = None):
    """A batch of fresh tracker states with leading `seq` axis, sharded."""
    one = tracker.init_state(cfg)
    batch = jax.tree.map(lambda a: jnp.broadcast_to(a, (num_seqs,) + a.shape).copy(), one)
    if mesh is not None:
        batch = jax.tree.map(
            lambda a: jax.device_put(a, NamedSharding(mesh, P(*(("seq",) + (None,) * (a.ndim - 1))))),
            batch,
        )
    return batch


@functools.partial(jax.jit, static_argnames=("cfg",))
def track_frame_batch(cfg: FrontendConfig, cams: StereoCamera, states, imgs0, imgs1, keys):
    """One tracking step for S independent sequences.

    Args:
      cams: StereoCamera pytree with leading (S,) axis (per-sequence intrinsics).
      states: TrackerState pytree with leading (S,) axis.
      imgs0/imgs1: (S, H, W) stereo frames.
      keys: (S, 2) PRNG keys.
    Under a mesh, the leading axis is sharded over `seq`, so each device
    advances its own sequences; there are no collectives in this program.
    """
    cfg = _batched_fcfg(cfg)
    step = lambda cam, st, i0, i1, k: tracker.track_frame(
        cfg, cam, st, i0, i1, rng_key=k
    )
    return jax.vmap(step)(cams, states, imgs0, imgs1, keys)


def shard_batch(mesh: Mesh, tree):
    """Place a leading-axis batch pytree on the mesh's seq axis."""
    return jax.tree.map(
        lambda a: jax.device_put(
            a, NamedSharding(mesh, P(*(("seq",) + (None,) * (a.ndim - 1))))
        ),
        tree,
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def track_frames_scan_batch(cfg: FrontendConfig, cams: StereoCamera,
                            states, imgs0, imgs1):
    """Chunked replay for S independent sequences: lax.scan over T frames of
    the vmapped per-frame step — ONE device program for S·T tracking steps.

    The full-throughput configuration (the "all EuRoC runs at once" mode):
    no per-frame dispatch, no per-sequence dispatch, no collectives.
    Structured as scan-of-vmap, NOT vmap-of-scan: vmapping a scanned tracker
    batches the loop carry through gather/scatter lowerings, while scanning
    the vmapped step keeps each iteration identical to track_frame_batch.

    Args:
      imgs0/imgs1: (S, T, H, W) stacked frames per sequence.
    Returns: (states, FrameOutput with leading (S, T) axes).
    """
    cfg = _batched_fcfg(cfg)
    xs = (jnp.swapaxes(imgs0, 0, 1), jnp.swapaxes(imgs1, 0, 1))  # (T, S, H, W)

    def step(sts, x):
        i0, i1 = x
        vstep = jax.vmap(
            lambda cam, st, a, b: tracker.track_frame(cfg, cam, st, a, b))
        return vstep(cams, sts, i0, i1)

    states, outs = jax.lax.scan(step, states, xs)
    # (T, S, ...) → (S, T, ...)
    outs = jax.tree.map(lambda a: jnp.swapaxes(a, 0, 1), outs)
    return states, outs


# --------------------------------------------------------------------------
# FULL-SYSTEM data parallelism: the fused frontend + sliding-window-BA (+VIO)
# chunk programs batched over a leading (S,) sequence axis — the complete
# "all 11 EuRoC runs sharded over the mesh" configuration, not just the
# tracker.  Same scan-of-vmap structure as track_frames_scan_batch; under
# vmap the per-keyframe lax.cond in the BA tail lowers to a select (both
# branches run every frame), which costs ~1.8× the keyframe-only BA work at
# the benched 0.55 keyframe fraction — the price of lockstep batching, paid
# once per device rather than per sequence.
# --------------------------------------------------------------------------


def _batched_fcfg(fcfg: FrontendConfig) -> FrontendConfig:
    # Under vmap the PnP-rescue lax.cond lowers to select, so EVERY frame of
    # EVERY sequence pays the full 128-hypothesis RANSAC the rescue only
    # needs on inlier starvation (config.py pnp_fallback note) — disable it
    # for batched runs; a starved sequence then escapes/recovers through
    # the two-strike path like the reference does without its
    # solvePnPRansac fallback.
    return dataclasses.replace(fcfg, pnp_fallback=False)


def init_system_states(fcfg: FrontendConfig, bcfg: BackendConfig,
                       num_seqs: int, mesh: Mesh | None = None,
                       vcfg: VioConfig | None = None):
    """Batched (tracker, BA window, pending-correction[, VIO]) states with a
    leading `seq` axis, sharded over the mesh."""
    ones = [tracker.init_state(fcfg), window_ba.empty(bcfg),
            window_ba.null_correction(bcfg)]
    if vcfg is not None:
        ones.append(vimotion.init_state(vcfg))
    out = []
    for one in ones:
        batch = jax.tree.map(
            lambda a: jnp.broadcast_to(a, (num_seqs,) + a.shape).copy(), one)
        if mesh is not None:
            batch = shard_batch(mesh, batch)
        out.append(batch)
    return tuple(out)


@functools.partial(jax.jit, static_argnames=("fcfg", "bcfg", "ba_every"))
def system_chunk_batch(fcfg: FrontendConfig, bcfg: BackendConfig, cams,
                       fe_states, ba_states, corrs, imgs0, imgs1,
                       ba_every: int = 1):
    """Fused frontend+backend chunk for S independent sequences: lax.scan
    over T frames of the vmapped per-frame step (runner._fused_frame_step).

    Args:
      cams: StereoCamera pytree with leading (S,) axis.
      fe_states/ba_states/corrs: batched states (init_system_states).
      imgs0/imgs1: (S, T, H, W) stacked frames, seq-sharded under a mesh.
      ba_every: window-BA cadence.  1 (default) = per-keyframe, exactly the
        single-sequence semantics — but under vmap the keyframe lax.cond
        lowers to select, so EVERY frame of every sequence pays the full
        12+8 Schur solve (~2.4× lockstep overhead at the benched 0.55
        keyframe fraction).  N>1 = keyframes still enter the window every
        frame (cheap masked insert), but the solve runs once per N frames
        on a SCAN-UNIFORM schedule (a real branch, since the predicate is
        the frame index, not per-sequence data); its Correction is applied
        on the next frame.  Corrections then arrive ≤N frames late — the
        same "feedback arrives K frames late and is rebased" contract the
        reference's async BA topic has (f2f_tracking.cpp:189-219).  With
        the 0.55 keyframe fraction, ba_every=2 runs FEWER solves than
        keyframe cadence at sub-mm trajectory deviation (test_parallel.py
        TestSystemDPBaCadence).
    Returns: (fe_states, ba_states, corrs, FrameOutput (S, T, ...),
      ba costs (S, T); with ba_every>1 cost rows are 0 on non-BA frames).
    """
    fcfg = _batched_fcfg(fcfg)
    null = window_ba.null_correction(bcfg)
    xs = (jnp.swapaxes(imgs0, 0, 1), jnp.swapaxes(imgs1, 0, 1))

    if ba_every == 1:
        def step(carry, x):
            fes, bas, cs = carry
            i0, i1 = x

            def one(cam, fe, ba, corr, a, b):
                (fe, ba, corr), (out, _pkt, _corr, cost) = \
                    runner_m._fused_frame_step(fcfg, bcfg, cam, null,
                                               (fe, ba, corr), (a, b))
                return (fe, ba, corr), (out, cost)

            (fes, bas, cs), ys = jax.vmap(one)(cams, fes, bas, cs, i0, i1)
            return (fes, bas, cs), ys

        (fe_states, ba_states, corrs), (outs, costs) = jax.lax.scan(
            step, (fe_states, ba_states, corrs), xs)
        outs = jax.tree.map(lambda a: jnp.swapaxes(a, 0, 1), outs)
        return fe_states, ba_states, corrs, outs, jnp.swapaxes(costs, 0, 1)

    T = imgs0.shape[1]
    xs = xs + (jnp.arange(T, dtype=jnp.int32),)

    def step(carry, x):
        fes, bas, cs = carry
        i0, i1, t = x

        def track_one(cam, fe, ba, corr, a, b):
            fe = tracker.apply_correction_(fe, corr)
            fe, out = tracker.track_frame(fcfg, cam, fe, a, b)
            ba = jax.lax.cond(out.reset_backend,
                              lambda s: window_ba.reset(bcfg, s),
                              lambda s: s, ba)
            pkt = tracker.make_keyframe_packet(fe, out)
            ba = jax.lax.cond(out.is_keyframe,
                              lambda s: window_ba.add_keyframe(bcfg, s, pkt),
                              lambda s: s, ba)
            return fe, ba, out

        fes, bas, outs = jax.vmap(track_one)(cams, fes, bas, cs, i0, i1)

        def do_ba(b):
            def one(cam, ba):
                res = window_ba.optimize(bcfg, cam, ba)
                return res.state, res.correction, res.cost
            return jax.vmap(one)(cams, b)

        def no_ba(b):
            S = imgs0.shape[0]
            null_b = jax.tree.map(
                lambda a: jnp.broadcast_to(a, (S,) + a.shape), null)
            return b, null_b, jnp.zeros(S, jnp.float32)

        # Scan-uniform predicate → a REAL branch: the solve executes only
        # on every ba_every-th frame of the chunk.
        bas, cs_new, costs = jax.lax.cond(
            t % ba_every == ba_every - 1, do_ba, no_ba, bas)
        return (fes, bas, cs_new), (outs, costs)

    (fe_states, ba_states, corrs), (outs, costs) = jax.lax.scan(
        step, (fe_states, ba_states, corrs), xs)
    outs = jax.tree.map(lambda a: jnp.swapaxes(a, 0, 1), outs)
    return fe_states, ba_states, corrs, outs, jnp.swapaxes(costs, 0, 1)


@functools.partial(jax.jit,
                   static_argnames=("fcfg", "bcfg", "vcfg", "ba_every"))
def system_chunk_batch_vio(fcfg: FrontendConfig, bcfg: BackendConfig,
                           vcfg: VioConfig, cams, T_i_cs, fe_states,
                           ba_states, vio_states, corrs, imgs0, imgs1, ts,
                           acc, gyro, imu_t, imu_valid, ba_every: int = 1):
    """system_chunk_batch with the full per-frame VIO loop (IMU propagation,
    feedforward prior, RP blend, bias feedback) vmapped over sequences —
    runner._fused_vio_frame_step under scan-of-vmap.

    Extra args: T_i_cs: SE3 with leading (S,); ts (S, T); acc/gyro
    (S, T, P, 3); imu_t/imu_valid (S, T, P) (see runner.pack_imu_frames).
    ba_every: same deferred scan-uniform window-BA cadence as
    system_chunk_batch (the vmapped keyframe lax.cond lowers to select, so
    per-keyframe cadence pays the full Schur solve every frame of every
    sequence; N>1 runs the solve once per N frames as a REAL branch with
    corrections ≤N frames late — the reference's async-feedback contract).
    """
    fcfg = _batched_fcfg(fcfg)
    null = window_ba.null_correction(bcfg)
    sw = lambda a: jnp.swapaxes(a, 0, 1)
    xs = tuple(map(sw, (imgs0, imgs1, ts, acc, gyro, imu_t, imu_valid)))

    if ba_every == 1:
        def step(carry, x):
            fes, bas, vios, cs = carry

            def one(cam, T_i_c, fe, ba, vio, corr, *x_one):
                (fe, ba, vio, corr), (out, _pkt, _corr, cost) = \
                    runner_m._fused_vio_frame_step(fcfg, bcfg, vcfg, cam,
                                                   T_i_c, null,
                                                   (fe, ba, vio, corr),
                                                   x_one)
                return (fe, ba, vio, corr), (out, cost)

            (fes, bas, vios, cs), ys = jax.vmap(one)(cams, T_i_cs, fes, bas,
                                                     vios, cs, *x)
            return (fes, bas, vios, cs), ys

        (fe_states, ba_states, vio_states, corrs), (outs, costs) = \
            jax.lax.scan(step, (fe_states, ba_states, vio_states, corrs), xs)
        outs = jax.tree.map(sw, outs)
        return (fe_states, ba_states, vio_states, corrs, outs, sw(costs))

    T = imgs0.shape[1]
    xs = xs + (jnp.arange(T, dtype=jnp.int32),)

    def step(carry, x):
        fes, bas, vios, cs = carry
        *x_seq, t = x

        def track_one(cam, T_i_c, fe, ba, vio, corr, *x_one):
            fe, vio, out = runner_m._vio_frame_core(
                fcfg, vcfg, cam, T_i_c, fe, vio, corr, x_one)
            ba = jax.lax.cond(out.reset_backend,
                              lambda s: window_ba.reset(bcfg, s),
                              lambda s: s, ba)
            pkt = tracker.make_keyframe_packet(fe, out)
            ba = jax.lax.cond(out.is_keyframe,
                              lambda s: window_ba.add_keyframe(bcfg, s, pkt),
                              lambda s: s, ba)
            return fe, ba, vio, out

        fes, bas, vios, outs = jax.vmap(track_one)(cams, T_i_cs, fes, bas,
                                                   vios, cs, *x_seq)

        def do_ba(b):
            def one(cam, ba):
                res = window_ba.optimize(bcfg, cam, ba)
                return res.state, res.correction, res.cost
            return jax.vmap(one)(cams, b)

        def no_ba(b):
            S = imgs0.shape[0]
            null_b = jax.tree.map(
                lambda a: jnp.broadcast_to(a, (S,) + a.shape), null)
            return b, null_b, jnp.zeros(S, jnp.float32)

        bas, cs_new, costs = jax.lax.cond(
            t % ba_every == ba_every - 1, do_ba, no_ba, bas)
        return (fes, bas, vios, cs_new), (outs, costs)

    (fe_states, ba_states, vio_states, corrs), (outs, costs) = jax.lax.scan(
        step, (fe_states, ba_states, vio_states, corrs), xs)
    outs = jax.tree.map(sw, outs)
    return (fe_states, ba_states, vio_states, corrs, outs, sw(costs))


# ---------------------------------------------------------------------------
# Explicit-SPMD wrappers: shard_map over the `seq` mesh axis.
#
# The chunk programs above are embarrassingly parallel along `seq`, but
# GSPMD auto-partitioning of the plain jitted program is NOT: the compiled
# 2-device partition of system_chunk_batch carried 56 all-gathers and 156
# all-reduces (XLA replicated/resharded intermediates it could not prove
# batch-parallel).  On one device those are cheap copies; across devices
# and processes every step pays them.  shard_map makes the
# parallelism a construction fact instead of a compiler inference: each
# shard compiles the single-sequence-block program with ZERO collectives,
# which is also the right shape for multi-device DP (no cross-device
# traffic in the steady state; "annotate and let XLA insert collectives"
# degenerates here to "there are none").
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _sharded_system_fn(mesh: Mesh, fcfg: FrontendConfig, bcfg: BackendConfig,
                       ba_every: int):
    # Cached per (mesh, cfgs, cadence): rebuilding jit(shard_map(...)) per
    # call would recompile the chunk program every step.
    def body(cams, fe, ba, corr, i0, i1):
        return system_chunk_batch(fcfg, bcfg, cams, fe, ba, corr, i0, i1,
                                  ba_every=ba_every)

    # check_vma=False: the body is batch-parallel by construction; the
    # variance checker rejects the nested jitted program's internal
    # constants (pvary on already-varying values).
    return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("seq"),) * 6,
                                 out_specs=P("seq"), check_vma=False))


def system_chunk_batch_sharded(mesh: Mesh, fcfg: FrontendConfig,
                               bcfg: BackendConfig, cams, fe_states,
                               ba_states, corrs, imgs0, imgs1,
                               ba_every: int = 1):
    """system_chunk_batch under shard_map(P('seq')) — see module note."""
    fn = _sharded_system_fn(mesh, fcfg, bcfg, ba_every)
    return fn(cams, fe_states, ba_states, corrs, imgs0, imgs1)


@functools.lru_cache(maxsize=None)
def _sharded_system_vio_fn(mesh: Mesh, fcfg: FrontendConfig,
                           bcfg: BackendConfig, vcfg: VioConfig,
                           ba_every: int):
    def body(cams, T_i_cs, fe, ba, vio, corr, i0, i1, ts, acc, gyro,
             imu_t, imu_valid):
        return system_chunk_batch_vio(
            fcfg, bcfg, vcfg, cams, T_i_cs, fe, ba, vio, corr, i0, i1, ts,
            acc, gyro, imu_t, imu_valid, ba_every=ba_every)

    return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("seq"),) * 13,
                                 out_specs=P("seq"), check_vma=False))


def system_chunk_batch_vio_sharded(mesh: Mesh, fcfg: FrontendConfig,
                                   bcfg: BackendConfig, vcfg: VioConfig,
                                   cams, T_i_cs, fe_states, ba_states,
                                   vio_states, corrs, imgs0, imgs1, ts,
                                   acc, gyro, imu_t, imu_valid,
                                   ba_every: int = 1):
    """system_chunk_batch_vio under shard_map(P('seq')) — see module note."""
    fn = _sharded_system_vio_fn(mesh, fcfg, bcfg, vcfg, ba_every)
    return fn(cams, T_i_cs, fe_states, ba_states, vio_states, corrs,
              imgs0, imgs1, ts, acc, gyro, imu_t, imu_valid)
