"""Distributed sliding-window bundle adjustment over a device mesh.

The scaling design from SURVEY.md §2.3 / BASELINE.json: landmark blocks are
partitioned across devices; each device forms the Schur complement
contribution of ITS landmarks locally (Hll inversion and back-substitution
never leave the device), and only the small reduced camera system — (W,6,6)
partial sums — crosses the interconnect via psum.  Communication per LM
iteration is O(W²·36) floats regardless of landmark count, so the collective
is bound by interconnect latency, not bandwidth.

The reference's g2o backend is a single-threaded CPU solver
(/root/reference/src/backend/vo_localmap.cpp:292-319); it has no distributed
story — this module is where this engine goes beyond it.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..backend import window_ba
from ..backend.window_ba import WindowState
from ..config import BackendConfig
from ..geometry.camera import StereoCamera
from ..geometry.se3 import SE3


def make_lm_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()[: n_devices or len(jax.devices())]
    return jax.make_mesh((len(devs),), ("lm",), devices=devs,
                         axis_types=(jax.sharding.AxisType.Auto,))


def shard_window_state(mesh: Mesh, state: WindowState) -> WindowState:
    """Place the landmark axis of a WindowState on the mesh's `lm` axis.

    Pose arrays (leading W axis) are replicated; per-landmark arrays (L) and
    observation matrices (W, L) are sharded on L.
    """
    def put(a, spec):
        return jax.device_put(a, NamedSharding(mesh, spec))

    return WindowState(
        kf_q=put(state.kf_q, P()), kf_t=put(state.kf_t, P()),
        kf_frame_id=put(state.kf_frame_id, P()), kf_valid=put(state.kf_valid, P()),
        lm_pw=put(state.lm_pw, P("lm")), lm_id=put(state.lm_id, P("lm")),
        lm_valid=put(state.lm_valid, P("lm")),
        obs_uv=put(state.obs_uv, P(None, "lm")),
        obs_ur=put(state.obs_ur, P(None, "lm")),
        obs_ur_valid=put(state.obs_ur_valid, P(None, "lm")),
        obs_valid=put(state.obs_valid, P(None, "lm")),
        head=put(state.head, P()), count=put(state.count, P()),
    )


@functools.partial(jax.jit, static_argnames=("cfg", "mesh"))
def optimize_sharded(cfg: BackendConfig, mesh: Mesh, cam: StereoCamera,
                     state: WindowState):
    """The two-phase windowed BA with the landmark axis sharded over `lm`.

    Same math and schedule as window_ba.optimize; the per-shard step reuses
    window_ba's internals with an axis_name so partial pose-system sums are
    psum-reduced.  Returns (poses SE3 (W,), lm_pw (L, 3), cost).
    """
    poses = state.poses()
    w_mask_full = state.obs_valid & state.kf_valid[:, None] & state.lm_valid[None, :]
    fid = jnp.where(state.kf_valid, state.kf_frame_id, jnp.iinfo(jnp.int32).max)
    fixed_pose = jnp.arange(state.window) == jnp.argmin(fid)

    def shard_fn(poses, lm_pw, obs_uv, obs_ur, obs_ur_valid, w_mask, fixed_pose):
        obs = (obs_uv, obs_ur, obs_ur_valid & w_mask)
        poses1, lm1, _ = window_ba._lm_loop(
            cam, poses, lm_pw, obs, w_mask, fixed_pose, cfg.iters1,
            cfg.huber_delta, axis_name="lm",
        )
        r1, _ = window_ba._residuals(cam, poses1, lm1, obs_uv, obs_ur,
                                     obs_ur_valid & w_mask)
        chi2 = jnp.sum(r1 * r1, axis=1)                   # r is (W, 3, L)
        w_mask2 = w_mask & (chi2 < cfg.chi2_cull)
        obs2 = (obs_uv, obs_ur, obs_ur_valid & w_mask2)
        poses2, lm2, cost = window_ba._lm_loop(
            cam, poses1, lm1, obs2, w_mask2, fixed_pose, cfg.iters2,
            cfg.huber_delta, axis_name="lm",
        )
        return poses2, lm2, cost

    shardmapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P("lm"), P(None, "lm"), P(None, "lm"), P(None, "lm"),
                  P(None, "lm"), P()),
        out_specs=(P(), P("lm"), P()),
    )
    poses2, lm2, cost = shardmapped(
        poses, state.lm_pw, state.obs_uv, state.obs_ur, state.obs_ur_valid,
        w_mask_full, fixed_pose,
    )
    ready = state.count >= 3
    poses_out = jax.tree.map(lambda a, b: jnp.where(ready, b, a), poses, poses2)
    lm_out = jnp.where(ready, lm2, state.lm_pw)
    return poses_out, lm_out, cost


# ---------------------------------------------------------------------------
# Fused chunk with the sharded BA INSIDE: the whole frontend+backend replay
# program under shard_map — frontend replicated on every device (pure
# compute, no communication), the BA window's landmark axis sharded, with
# psum for the reduced pose system and one all_gather per keyframe to
# re-assemble the feedback Correction for the (replicated) tracker.  This is
# SURVEY §2.3's "distributed sliding-window BA overlapped with the
# frontend" as a single compiled program.
# ---------------------------------------------------------------------------


def _ws_specs():
    from ..backend.window_ba import WindowState as WS

    return WS(kf_q=P(), kf_t=P(), kf_frame_id=P(), kf_valid=P(),
              lm_pw=P("lm"), lm_id=P("lm"), lm_valid=P("lm"),
              obs_uv=P(None, "lm"), obs_ur=P(None, "lm"),
              obs_ur_valid=P(None, "lm"), obs_valid=P(None, "lm"),
              head=P(), count=P())


def _corr_specs():
    from ..backend.window_ba import Correction

    return Correction(frame_id=P(), q=P(), t=P(),
                      lm_id=P("lm"), lm_pw=P("lm"), lm_mask=P("lm"),
                      outlier_id=P("lm"), outlier_mask=P("lm"), valid=P())


def shard_correction(mesh: Mesh, corr) -> "window_ba.Correction":
    """Place a Correction's landmark arrays on the mesh's lm axis."""
    return jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
        corr, _corr_specs())


@functools.partial(jax.jit, static_argnames=("fcfg", "bcfg", "mesh"))
def chunk_fused_sharded(fcfg, bcfg: BackendConfig, mesh: Mesh, cam,
                        fe_state, ba_state: WindowState, corr,
                        imgs0, imgs1):
    """runner._chunk_fused with the window BA landmark-sharded over `lm`.

    Args match runner._chunk_fused plus the mesh; ba_state via
    shard_window_state, corr via shard_correction.  Returns
    (fe_state, ba_state, corr, (outs, costs)).
    """
    from ..frontend import tracker

    def body(fe_state, ba_state, corr, imgs0, imgs1):
        null = window_ba.null_correction_like(ba_state)

        def gather_corr(c):
            ag = lambda a: jax.lax.all_gather(a, "lm", tiled=True)
            return c._replace(
                lm_id=ag(c.lm_id), lm_pw=ag(c.lm_pw), lm_mask=ag(c.lm_mask),
                outlier_id=ag(c.outlier_id), outlier_mask=ag(c.outlier_mask))

        def step(carry, xs):
            fe, ba, corr = carry
            i0, i1 = xs
            # The tracker is replicated; the Correction's landmark rows are
            # shard-local → one small all_gather re-assembles them (the only
            # collective outside the BA solve).
            fe = tracker.apply_correction(fe, gather_corr(corr))
            fe, out = tracker.track_frame(fcfg, cam, fe, i0, i1)
            ba = jax.lax.cond(out.reset_backend,
                              lambda b: window_ba.reset(bcfg, b),
                              lambda b: b, ba)
            pkt = tracker.make_keyframe_packet(fe, out)

            def do_kf(b):
                st = window_ba.add_keyframe(bcfg, b, pkt, axis_name="lm")
                res = window_ba.optimize(bcfg, cam, st, axis_name="lm")
                return res.state, res.correction, res.cost

            def no_kf(b):
                return b, null, jnp.asarray(0.0, jnp.float32)

            ba, corr_new, cost = jax.lax.cond(out.is_keyframe, do_kf, no_kf, ba)
            return (fe, ba, corr_new), (out, cost)

        (fe_state, ba_state, corr), ys = jax.lax.scan(
            step, (fe_state, ba_state, corr), (imgs0, imgs1))
        return fe_state, ba_state, corr, ys

    ws, cs = _ws_specs(), _corr_specs()
    # check_vma off: the tracker side is replicated BY CONSTRUCTION (every
    # shard applies the same all_gather-ed Correction to the same state),
    # but the static varying-axes analysis cannot prove an all_gather output
    # replicated and would poison every downstream while_loop carry.
    shardmapped = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), ws, cs, P(), P()),
        out_specs=(P(), ws, cs, (P(), P())),
        check_vma=False,
    )
    return shardmapped(fe_state, ba_state, corr, imgs0, imgs1)
