"""VIMOTION: IMU attitude/position propagation with vision feedback.

Array-native re-design of the reference's VIMOTION
(/root/reference/src/processing/vi_motion.cpp): a mutex-guarded deque of 400
MOTION_STATE{pos, vel, q_w_i, imu} entries (vi_motion.h:10-17), a Madgwick
complementary filter for attitude during init (vi_motion.cpp:34-115) and
propagation (139-209), Euler position/velocity integration under gravity,
a *feedforward* pose query at image timestamps for the tracker
(viGetCorrFrameState, 416-435) with roll/pitch blending into the vision pose
(viVisionRPCompensation, 437-464), and *feedback* accelerometer/gyro bias
estimation from vision pose pairs with saturation and IIR smoothing
(viCorrectionFromVision, 212-342).  This feedforward-feedback loop is the
system's namesake.

Here the deque becomes a fixed ring of arrays; a batch of IMU samples is
integrated with one lax.scan; the state-index search (viFindStateIdx,
348-383) is a vectorised argmin over timestamps; and the rebase of newer
states onto a corrected pose (275-282) is a masked broadcast update.
Everything is jit-safe fixed shape.

Frame conventions: world = ENU with gravity -z (the nodelet remaps each
device's IMU axes to ENU before feeding, vo_tracking.cpp:331-357 — our
dataset drivers do the same on host).  q_w_i rotates IMU-frame vectors into
world.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import VioConfig
from ..geometry import se3 as se3m, so3
from ..geometry.se3 import SE3


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class VioState:
    # Ring buffer, chronological by slot age: `head` points at the slot the
    # NEXT sample will overwrite; valid entries are the `count` most recent.
    t: jax.Array           # (C,) seconds
    pos: jax.Array         # (C, 3)
    vel: jax.Array         # (C, 3)
    q: jax.Array           # (C, 4) q_w_i
    acc: jax.Array         # (C, 3) raw
    gyro: jax.Array        # (C, 3) raw
    head: jax.Array        # i32
    count: jax.Array       # i32
    bias_acc: jax.Array    # (3,)
    bias_gyro: jax.Array   # (3,)
    initialized: jax.Array  # bool
    init_acc_sum: jax.Array   # (3,) gravity-direction accumulator
    init_gyro_sum: jax.Array  # (3,)
    init_count: jax.Array     # i32
    # Previous ACCEPTED vision pose (T_w_i) + its image time — the reference
    # passes (t_last, Tcw_last) into every viCorrectionFromVision call
    # (vi_motion.cpp:212-216); carrying it here keeps the one-argument call
    # sites.  last_vis_t < 0 means "no prior vision lock yet".
    last_vis_t: jax.Array     # scalar
    last_vis_q: jax.Array     # (4,) q_w_i of the last vision pose
    last_vis_p: jax.Array     # (3,)


def init_state(cfg: VioConfig, dtype=jnp.float32) -> VioState:
    c = cfg.imu_capacity
    return VioState(
        t=jnp.full(c, -1.0, dtype), pos=jnp.zeros((c, 3), dtype),
        vel=jnp.zeros((c, 3), dtype),
        q=jnp.tile(jnp.asarray([1.0, 0, 0, 0], dtype), (c, 1)),
        acc=jnp.zeros((c, 3), dtype), gyro=jnp.zeros((c, 3), dtype),
        head=jnp.asarray(0, jnp.int32), count=jnp.asarray(0, jnp.int32),
        bias_acc=jnp.zeros(3, dtype), bias_gyro=jnp.zeros(3, dtype),
        initialized=jnp.asarray(False),
        init_acc_sum=jnp.zeros(3, dtype), init_gyro_sum=jnp.zeros(3, dtype),
        init_count=jnp.asarray(0, jnp.int32),
        last_vis_t=jnp.asarray(-1.0, dtype),
        last_vis_q=jnp.asarray([1.0, 0, 0, 0], dtype),
        last_vis_p=jnp.zeros(3, dtype),
    )


def _latest(state: VioState):
    idx = (state.head - 1) % state.t.shape[0]
    return idx


def _attitude_from_gravity(acc):
    """Initial roll/pitch from the measured gravity direction (yaw = 0) —
    the attitude seed of viIMUinitialization (vi_motion.cpp:67-113)."""
    a = acc / jnp.maximum(jnp.linalg.norm(acc), 1e-6)
    roll = jnp.arctan2(a[1], a[2])
    pitch = jnp.arctan2(-a[0], jnp.sqrt(a[1] ** 2 + a[2] ** 2))
    return so3.from_euler_zyx(jnp.stack([roll, pitch, jnp.zeros_like(roll)]))


def _madgwick_step(q, gyro, acc, beta, dt):
    """One Madgwick complementary-filter update of q_w_i.

    Gyro integration plus a gradient-descent correction pulling the predicted
    gravity direction toward the accelerometer measurement, weighted by beta
    (vifusion_para1) — vi_motion.cpp:160-190.
    """
    # Gyro propagation: q ← q ⊗ exp(ω dt).
    q_prop = so3.mul(q, so3.exp(gyro * dt))
    # Accel correction: rotate measured acc to world; error vs +z (ENU).
    a_norm = jnp.linalg.norm(acc)
    a = acc / jnp.maximum(a_norm, 1e-6)
    g_pred = so3.rotate(so3.conj(q_prop), jnp.asarray([0.0, 0.0, 1.0], q.dtype))
    err = jnp.cross(a, g_pred)  # rotation axis (IMU frame) aligning a → g_pred
    # Only correct when the accelerometer is plausibly measuring gravity.
    trust = jnp.exp(-jnp.abs(a_norm - 9.81) / 9.81 * 5.0)
    # Proportional pull toward the accelerometer gravity direction with rate
    # constant 10·beta rad/s per rad of error (beta=0.05 → τ = 2 s), the
    # complementary-filter role of vifusion_para1 in the reference.
    corr = so3.exp(err * (10.0 * beta) * trust * dt)
    return so3.normalize(so3.mul(q_prop, corr))


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnames=("state",))
def imu_feed_batch(cfg: VioConfig, state: VioState, acc_batch, gyro_batch, t_batch,
                   valid=None):
    """Integrate a batch of IMU samples (arrays (B, 3), (B, 3), (B,)).

    Replaces the per-sample imu_feed callback path
    (f2f_tracking.cpp:46-57 → viIMUinitialization / viIMUPropagation) with
    one device program per inter-frame IMU packet.  `valid` masks padding
    rows so callers can pad batches to a few fixed sizes and avoid
    per-shape recompiles.

    Two paths, selected on the initialized flag:
    - steady state (initialized): `_feed_prop_batch` — everything batchable
      (dt, bias removal, gyro delta quats, accel trust, the velocity and
      position integrals as cumsums) is vectorized over the packet, and
      only the irreducible sequential attitude recurrence
      (`attitude_chain`) stays serial, as an unrolled chain of small
      elementwise ops that XLA fuses.
    - during initialization: `_feed_scan` — the faithful per-sample scan,
      which also handles the init→propagation transition mid-packet.
    """
    if valid is None:
        valid = jnp.ones(t_batch.shape[0], bool)
    return jax.lax.cond(
        state.initialized,
        lambda st: _feed_prop_batch(cfg, st, acc_batch, gyro_batch, t_batch,
                                    valid),
        lambda st: _feed_scan(cfg, st, acc_batch, gyro_batch, t_batch, valid),
        state)


def _ring_append(state: VioState, valid, rows):
    """Append per-sample rows (t, q, pos, vel, acc, gyro) to the ring with
    one batched scatter per field; rows with valid=False are dropped."""
    C = state.t.shape[0]
    vi = valid.astype(jnp.int32)
    n_ok = jnp.sum(vi)
    slot = (state.head + jnp.cumsum(vi) - vi) % C      # exclusive prefix sum
    idx = jnp.where(valid, slot, C)                    # C = out of bounds
    r_t, r_q, r_p, r_v, r_a, r_g = rows
    return dataclasses.replace(
        state,
        t=state.t.at[idx].set(r_t, mode="drop"),
        q=state.q.at[idx].set(r_q, mode="drop"),
        pos=state.pos.at[idx].set(r_p, mode="drop"),
        vel=state.vel.at[idx].set(r_v, mode="drop"),
        acc=state.acc.at[idx].set(r_a, mode="drop"),
        gyro=state.gyro.at[idx].set(r_g, mode="drop"),
        head=(state.head + n_ok) % C,
        count=jnp.minimum(state.count + n_ok, C),
    )


def attitude_chain(q0, G, a_unit, c):
    """Sequential Madgwick attitude chain of one IMU packet:

        q_k = normalize( (q_{k-1} ⊗ G_k) ⊗ exp(c_k · a_k × ĝ(q_{k-1} ⊗ G_k)) )

    q0 (4,) start quaternion; G (P,4) per-sample gyro delta quaternions
    (identity rows for masked samples); a_unit (P,3) unit accelerometer
    directions; c (P,) correction gains (0 for masked samples); ĝ is the
    predicted gravity direction in the IMU frame.  Returns (P,4)
    quaternions after each sample."""
    def step(q, xs):
        g, a, ck = xs
        qp = so3.mul(q, g)
        g_pred = so3.rotate(so3.conj(qp), jnp.asarray([0.0, 0.0, 1.0], q.dtype))
        err = jnp.cross(a, g_pred)
        q = so3.normalize(so3.mul(qp, so3.exp(err * ck)))
        return q, q

    _, qs = jax.lax.scan(step, q0, (G, a_unit, c), unroll=True)
    return qs


def _feed_prop_batch(cfg: VioConfig, state: VioState, acc_b, gyro_b, t_b,
                     valid):
    """Steady-state propagation of a whole packet: batched precompute +
    the sequential attitude chain + cumsum integrals.

    Equivalent to the sequential scan given monotonic IMU timestamps
    (always true of a real stream; the drivers and pack_imu_frames feed
    monotonic suffix-padded packets).
    """
    dtype = state.t.dtype
    g_w = jnp.asarray([0.0, 0.0, -cfg.gravity], dtype)
    j = _latest(state)
    t_l, q_l = state.t[j], state.q[j]
    p_l, v_l = state.pos[j], state.vel[j]
    am = acc_b - state.bias_acc[None, :]
    gm = gyro_b - state.bias_gyro[None, :]
    # Previous-valid-sample time via a running max (monotonic timestamps):
    # dt_k = clip(t_k − t_prev, 1e-4, 0.05) exactly as the sequential path.
    t_eff = jnp.where(valid, t_b, -jnp.inf)
    prev_t = jax.lax.cummax(jnp.concatenate([t_l[None], t_eff]))[:-1]
    dt = jnp.clip(t_b - prev_t, 1e-4, 0.05)
    G = so3.exp(gm * dt[:, None])
    G = jnp.where(valid[:, None], G,
                  jnp.asarray([1.0, 0, 0, 0], dtype)[None, :])
    a_norm = jnp.linalg.norm(am, axis=-1)
    a_unit = am / jnp.maximum(a_norm, 1e-6)[:, None]
    trust = jnp.exp(-jnp.abs(a_norm - 9.81) / 9.81 * 5.0)
    c = (10.0 * cfg.madgwick_beta) * trust * dt * valid
    qs = attitude_chain(q_l, G, a_unit, c)               # (P, 4)
    # Euler position/velocity integrals (vi_motion.cpp:192-199) as cumsums;
    # masked samples contribute zero (dt_v = 0) and their rows are dropped.
    acc_w = so3.rotate(qs, am) + g_w[None, :]
    dt_v = dt * valid
    vel = v_l[None, :] + jnp.cumsum(acc_w * dt_v[:, None], axis=0)
    vel_prev = jnp.concatenate([v_l[None, :], vel[:-1]], axis=0)
    pos = p_l[None, :] + jnp.cumsum(
        vel_prev * dt_v[:, None] + 0.5 * acc_w * (dt_v ** 2)[:, None], axis=0)
    return _ring_append(state, valid, (t_b, qs, pos, vel, acc_b, gyro_b))


def _feed_scan(cfg: VioConfig, state: VioState, acc_batch, gyro_batch,
               t_batch, valid):
    """Per-sample scan path (initialization + mixed init/prop packets).

    Scan carries ONLY the ~20-float integrator state (latest t/q/pos/vel +
    biases + init accumulators); ring rows are emitted as scan outputs and
    written back with one batched scatter per field, so the scan body is
    pure small-vector arithmetic instead of carrying the whole 400-row
    ring.
    """
    g_w = jnp.asarray([0.0, 0.0, -cfg.gravity])
    j = _latest(state)
    carry = (state.t[j], state.q[j], state.pos[j], state.vel[j],
             state.bias_acc, state.bias_gyro, state.initialized,
             state.init_acc_sum, state.init_gyro_sum, state.init_count)

    def step(carry, sample):
        t_l, q_l, p_l, v_l, ba, bg, inited, a_sum, g_sum, n_init = carry
        acc, gyro, t, ok = sample

        def do_init(_):
            n = n_init + 1
            a_s = a_sum + acc
            g_s = g_sum + gyro
            done = n >= cfg.init_samples
            # Seed attitude from the running gravity mean; latch the gyro
            # mean as the initial gyro bias when enough samples arrived.
            q0 = _attitude_from_gravity(a_s / n.astype(acc.dtype))
            bg2 = jnp.where(done, g_s / n.astype(acc.dtype), bg)
            z = jnp.zeros(3, acc.dtype)
            return (t, q0, z, z, ba, bg2, inited | done, a_s, g_s, n)

        def do_prop(_):
            dt = jnp.clip(t - t_l, 1e-4, 0.05)
            q = _madgwick_step(q_l, gyro - bg, acc - ba,
                               cfg.madgwick_beta, dt)
            # Position/velocity Euler integration with gravity
            # (vi_motion.cpp:192-199).
            acc_w = so3.rotate(q, acc - ba) + g_w
            vel = v_l + acc_w * dt
            pos = p_l + v_l * dt + 0.5 * acc_w * dt * dt
            return (t, q, pos, vel, ba, bg, inited, a_sum, g_sum, n_init)

        # Both branches are ~30 flops of small-vector math: evaluate both and
        # select, so the fully-unrolled scan below is one straight-line
        # fusible chain (a lax.cond would fence fusion at every sample).
        new = jax.tree.map(lambda a, b: jnp.where(inited, a, b),
                           do_prop(None), do_init(None))
        carry = jax.tree.map(lambda a, b: jnp.where(ok, b, a), carry, new)
        # Ring row for this sample (garbage when !ok — dropped by the
        # scatter below, exactly as the old masked in-scan write skipped it).
        row = (new[0], new[1], new[2], new[3], acc, gyro)
        return carry, row

    # Fully unroll the small per-frame packets (fixed P≤32) into one
    # straight-line fusible chain; long init/replay batches keep a rolled
    # scan with partial unroll to bound compile time.
    B = int(t_batch.shape[0])
    carry, rows = jax.lax.scan(
        step, carry, (acc_batch, gyro_batch, t_batch, valid),
        unroll=True if B <= 32 else 8)
    _, _, _, _, ba, bg, inited, a_sum, g_sum, n_init = carry

    state = _ring_append(state, valid, rows)
    return dataclasses.replace(
        state,
        bias_acc=ba, bias_gyro=bg, initialized=inited,
        init_acc_sum=a_sum, init_gyro_sum=g_sum, init_count=n_init,
    )


def find_state_idx(state: VioState, t_query):
    """Ring index of the newest state with t ≤ t_query (viFindStateIdx,
    vi_motion.cpp:348-383).  Vectorised masked argmax over the ring."""
    dt = t_query - state.t
    dt = jnp.where((state.t >= 0) & (dt >= 0), dt, jnp.inf)
    return jnp.argmin(dt)


class FeedforwardPose(NamedTuple):
    T_c_w: SE3
    q_w_i: jax.Array
    pos: jax.Array
    vel: jax.Array
    idx: jax.Array
    ok: jax.Array


@functools.partial(jax.jit, static_argnames=())
def get_frame_state(state: VioState, t_img, T_i_c: SE3) -> FeedforwardPose:
    """Feedforward: IMU pose prediction at an image timestamp
    (viGetCorrFrameState, vi_motion.cpp:416-435).

    T_i_c is the camera-in-IMU extrinsic; returns the predicted camera-from-
    world pose for the tracker's LK/PnP initial guess.
    """
    i = find_state_idx(state, t_img)
    q_w_i = state.q[i]
    pos = state.pos[i]
    T_w_i = SE3(q_w_i, pos)
    T_w_c = se3m.compose(T_w_i, T_i_c)
    T_c_w = se3m.inverse(T_w_c)
    # If NO buffered state lies at or before t_img, argmin over the all-inf
    # dt returns slot 0 — an arbitrary (future or wrapped) state; flag it.
    has_past = jnp.any((state.t >= 0) & (state.t <= t_img))
    ok = state.initialized & (state.count > 0) & has_past
    return FeedforwardPose(T_c_w, q_w_i, pos, state.vel[i], i, ok)


def vision_rp_compensation(q_vision_w_i, q_imu_w_i, blend):
    """Blend IMU roll/pitch into the vision attitude, keep vision yaw
    (viVisionRPCompensation, vi_motion.cpp:437-464; weight = vifusion_para2).

    Gravity makes roll/pitch observable from the IMU alone; yaw is not."""
    rpy_v = so3.to_euler_zyx(q_vision_w_i)
    rpy_i = so3.to_euler_zyx(q_imu_w_i)
    blended = jnp.stack(
        [
            (1.0 - blend) * rpy_v[..., 0] + blend * rpy_i[..., 0],
            (1.0 - blend) * rpy_v[..., 1] + blend * rpy_i[..., 1],
            rpy_v[..., 2],
        ],
        axis=-1,
    )
    return so3.from_euler_zyx(blended)


def rp_compensate_pose(cfg: VioConfig, T_c_w_vision: SE3, q_w_i_imu,
                       T_i_c: SE3) -> SE3:
    """Blend the IMU-propagated roll/pitch into a vision camera pose — the
    pipeline wiring of viVisionRPCompensation (f2f_tracking.cpp:251-254;
    weight = vifusion_para2 = cfg.rp_blend).  Converts the camera pose to
    the IMU/world frame (where gravity aligns roll/pitch), blends attitude
    only, keeps the vision position, and converts back."""
    T_w_c = se3m.inverse(T_c_w_vision)
    T_w_i_vis = se3m.compose(T_w_c, se3m.inverse(T_i_c))
    q_blend = vision_rp_compensation(T_w_i_vis.q, q_w_i_imu, cfg.rp_blend)
    T_w_i = SE3(so3.normalize(q_blend), T_w_i_vis.t)
    return se3m.inverse(se3m.compose(T_w_i, T_i_c))


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnames=("state",))
def correction_from_vision(cfg: VioConfig, state: VioState, t_img, T_c_w_vision: SE3,
                           T_i_c: SE3):
    """Feedback: correct the IMU state history from a vision pose and update
    bias estimates (viCorrectionFromVision, vi_motion.cpp:212-342).

    Reference semantics (A/B = vision poses at the last/current image, a/b =
    the ring states at those times):
    - Gyro-bias estimate: the quaternion xyz of Q_B_A·Q_b_a⁻¹ divided by dt
      — the per-second attitude drift of the IMU relative to vision over
      one frame interval (vi_motion.cpp:248-256).
    - Accel-bias estimate: −R(q_mid)ᵀ(v_vision − v̄_imu)/dt, where v_vision
      is the finite-difference vision velocity over the interval and v̄_imu
      the MEAN ring velocity across it (vi_motion.cpp:262-275).
    - Biases move by an IIR toward the instantaneous estimate —
      b ← (1−para_3)·b + gain·est — NOT by integrating the innovation: an
      integrator walks to its saturation on any systematic innovation (an
      earlier implementation did exactly that: bias_acc climbed to ba_sat
      while the ring velocity diverged on a 0.6 m/s trajectory).  Norm-clipped
      at ba_sat/bw_sat, NaN-guarded, skipped when dt ≥ 0.1 s
      (vi_motion.cpp:297-331).
    - Rebase: every state at/after the image time maps through
      T_diff = T_w_iB·T_w_ib⁻¹, and its VELOCITY gains the world-frame
      innovation diff_vel (vi_motion.cpp:277-284) — without the velocity
      term the accel-integration error is never corrected and compounds
      without bound.
    The previous vision pose rides inside VioState (last_vis_*); the first
    call after init snaps the pose chain but skips the velocity/bias terms.
    """
    eps = jnp.asarray(1e-6, state.t.dtype)
    i_b = find_state_idx(state, t_img)
    T_w_c = se3m.inverse(T_c_w_vision)
    T_w_iB = se3m.compose(T_w_c, se3m.inverse(T_i_c))

    t_last = state.last_vis_t
    i_a = find_state_idx(state, t_last)
    dt = t_img - t_last
    # `has_last_state`: the ring must still hold an entry at/before t_last
    # (the reference gates the whole correction on viFindStateIdx(t_last)
    # succeeding, vi_motion.cpp:229-238).  After a tracking gap long enough
    # to evict t_last, find_state_idx's masked argmin returns an arbitrary
    # slot and the innovation window would span inconsistent states —
    # mirror get_frame_state's has_past guard instead.
    has_last_state = jnp.any((state.t >= 0) & (state.t <= t_last))
    have_last = (t_last >= 0) & has_last_state & (i_a != i_b) & (dt > eps)

    # --- innovation terms (vision vs IMU over the frame interval) ---------
    q_BA = so3.mul(so3.conj(T_w_iB.q), state.last_vis_q)
    q_ba = so3.mul(so3.conj(state.q[i_b]), state.q[i_a])
    q_Bb = so3.normalize(so3.mul(q_BA, so3.conj(q_ba)))
    dt_safe = jnp.where(have_last, dt, 1.0)
    gyro_est = q_Bb[1:4] / dt_safe

    in_win = (state.t >= t_last) & (state.t <= t_img) & (state.t >= 0)
    n_win = jnp.maximum(jnp.sum(in_win), 1)
    vel_imu = jnp.sum(jnp.where(in_win[:, None], state.vel, 0.0), axis=0) / n_win
    vel_vis = (T_w_iB.t - state.last_vis_p) / dt_safe
    diff_vel = jnp.where(have_last, vel_vis - vel_imu, 0.0)   # world frame
    # Mid state by TIMESTAMP midpoint; the reference picks the INDEX
    # midpoint idx_last+floor((idx_curr-idx_last)/2) (vi_motion.cpp:265).
    # These diverge only when IMU samples are non-uniform inside one frame
    # interval — negligible at the fixed-rate streams this consumes.
    i_m = find_state_idx(state, 0.5 * (t_last + t_img))
    acc_est = -so3.rotate(so3.conj(state.q[i_m]), diff_vel) / dt_safe

    # --- bias IIR toward the estimates, norm-saturated, dt-gated ----------
    def sat(v, cap):
        n = jnp.linalg.norm(v)
        return v * jnp.minimum(1.0, cap / jnp.maximum(n, eps))

    acc_est = jnp.where(jnp.all(jnp.isfinite(acc_est)),
                        sat(acc_est, cfg.acc_bias_sat), 0.0)
    gyro_est = jnp.where(jnp.all(jnp.isfinite(gyro_est)),
                         sat(gyro_est, cfg.gyro_bias_sat), 0.0)
    upd = have_last & (dt < 0.1)
    p3, p4 = cfg.acc_bias_gain, cfg.gyro_bias_gain
    bias_acc = jnp.where(upd, (1.0 - p3) * state.bias_acc + p3 * acc_est,
                         state.bias_acc)
    # INTENTIONAL asymmetry (reference parity): the gyro IIR decays by
    # (1-para_3) but gains by para_4 (vi_motion.cpp:330), so with p3 != p4
    # from YAML the gyro-bias steady state scales by p4/p3.  Not a typo
    # here — changing it would diverge from the reference's tuning.
    bias_gyro = jnp.where(upd, (1.0 - p3) * state.bias_gyro + p4 * gyro_est,
                          state.bias_gyro)

    # Rebase every state at or after t_img: x ← Δ ∘ x with Δ the world-frame
    # correction that maps the old pose at i_b onto the vision pose, and the
    # velocity innovation added (vi_motion.cpp:277-284).
    newer = (state.t >= state.t[i_b]) & (state.t >= 0)
    dq = so3.mul(T_w_iB.q, so3.conj(state.q[i_b]))
    q_new = so3.normalize(so3.mul(dq[None, :], state.q))
    pos_new = so3.rotate(dq[None, :], state.pos - state.pos[i_b][None, :]) + T_w_iB.t[None, :]
    vel_new = state.vel + diff_vel[None, :]

    return dataclasses.replace(
        state,
        q=jnp.where(newer[:, None], q_new, state.q),
        pos=jnp.where(newer[:, None], pos_new, state.pos),
        vel=jnp.where(newer[:, None], vel_new, state.vel),
        bias_acc=bias_acc, bias_gyro=bias_gyro,
        last_vis_t=jnp.asarray(t_img, state.t.dtype),
        last_vis_q=T_w_iB.q, last_vis_p=T_w_iB.t,
    )
