"""VIMOTION tests: Madgwick attitude, propagation, feedforward/feedback."""

import jax.numpy as jnp
import numpy as np

from flvis_tpu.config import VioConfig
from flvis_tpu.geometry import se3, so3
from flvis_tpu.vio import vimotion


CFG = VioConfig(imu_capacity=256, init_samples=20)


def static_samples(n, dt=0.005, t0=0.0, rpy=(0.0, 0.0, 0.0), rng=None, noise=0.0):
    """IMU at rest with attitude rpy (world ENU, gravity -z): accelerometer
    measures +g rotated into the IMU frame."""
    q = so3.from_euler_zyx(jnp.asarray(rpy))
    g_imu = np.asarray(so3.rotate(so3.conj(q), jnp.asarray([0.0, 0.0, 9.81])))
    acc = np.tile(g_imu, (n, 1))
    gyro = np.zeros((n, 3))
    if rng is not None and noise > 0:
        acc = acc + rng.normal(scale=noise, size=acc.shape)
        gyro = gyro + rng.normal(scale=noise * 0.1, size=gyro.shape)
    t = t0 + dt * np.arange(1, n + 1)
    return jnp.asarray(acc, jnp.float32), jnp.asarray(gyro, jnp.float32), jnp.asarray(t, jnp.float32)


class TestInit:
    def test_initializes_after_enough_samples(self):
        st = vimotion.init_state(CFG)
        acc, gyro, t = static_samples(19)
        st = vimotion.imu_feed_batch(CFG, st, acc, gyro, t)
        assert not bool(st.initialized)
        acc, gyro, t = static_samples(5, t0=float(t[-1]))
        st = vimotion.imu_feed_batch(CFG, st, acc, gyro, t)
        assert bool(st.initialized)

    def test_init_attitude_matches_gravity(self):
        st = vimotion.init_state(CFG)
        rpy = (0.15, -0.1, 0.0)
        acc, gyro, t = static_samples(40, rpy=rpy)
        st = vimotion.imu_feed_batch(CFG, st, acc, gyro, t)
        i = int((st.head - 1) % CFG.imu_capacity)
        got = np.asarray(so3.to_euler_zyx(st.q[i]))
        np.testing.assert_allclose(got[:2], rpy[:2], atol=0.02)

    def test_gyro_bias_from_init(self, rng):
        st = vimotion.init_state(CFG)
        acc, gyro, t = static_samples(40)
        gyro = gyro + jnp.asarray([0.01, -0.02, 0.005])
        st = vimotion.imu_feed_batch(CFG, st, acc, gyro, t)
        np.testing.assert_allclose(st.bias_gyro, [0.01, -0.02, 0.005], atol=1e-4)


class TestPropagation:
    def _init(self):
        st = vimotion.init_state(CFG)
        acc, gyro, t = static_samples(30)
        return vimotion.imu_feed_batch(CFG, st, acc, gyro, t), float(t[-1])

    def test_static_stays_put(self):
        st, t0 = self._init()
        acc, gyro, t = static_samples(100, t0=t0)
        st = vimotion.imu_feed_batch(CFG, st, acc, gyro, t)
        i = int((st.head - 1) % CFG.imu_capacity)
        np.testing.assert_allclose(st.pos[i], 0.0, atol=0.01)
        np.testing.assert_allclose(st.vel[i], 0.0, atol=0.02)

    def test_yaw_rotation_integrates(self):
        st, t0 = self._init()
        # Rotate about world z at 0.5 rad/s for 1 s; gravity stays aligned.
        n, dt = 200, 0.005
        gyro = np.tile([0.0, 0.0, 0.5], (n, 1)).astype(np.float32)
        acc = np.tile([0.0, 0.0, 9.81], (n, 1)).astype(np.float32)
        t = t0 + dt * np.arange(1, n + 1)
        st = vimotion.imu_feed_batch(CFG, st, jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(t, jnp.float32))
        i = int((st.head - 1) % CFG.imu_capacity)
        rpy = np.asarray(so3.to_euler_zyx(st.q[i]))
        np.testing.assert_allclose(rpy[2], 0.5, atol=0.02)

    def test_acceleration_integrates_position(self):
        st, t0 = self._init()
        # 1 m/s² along world x for 0.5 s → p = 0.125 m, v = 0.5 m/s.  The
        # complementary filter inevitably tilts slightly under sustained
        # lateral acceleration (vision feedback corrects that in the full
        # system), so tolerances are loose but catch sign/scale errors.
        n, dt = 100, 0.005
        acc = np.tile([1.0, 0.0, 9.81], (n, 1)).astype(np.float32)
        gyro = np.zeros((n, 3), np.float32)
        t = t0 + dt * np.arange(1, n + 1)
        st = vimotion.imu_feed_batch(CFG, st, jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(t, jnp.float32))
        i = int((st.head - 1) % CFG.imu_capacity)
        np.testing.assert_allclose(st.pos[i], [0.125, 0, 0], atol=0.05)
        np.testing.assert_allclose(st.vel[i], [0.5, 0, 0], atol=0.1)


class TestFeedforwardFeedback:
    def _init(self):
        st = vimotion.init_state(CFG)
        acc, gyro, t = static_samples(60)
        return vimotion.imu_feed_batch(CFG, st, acc, gyro, t), float(t[-1])

    def test_get_frame_state(self):
        st, t0 = self._init()
        T_i_c = se3.identity()
        ff = vimotion.get_frame_state(st, jnp.asarray(t0 - 0.001), T_i_c)
        assert bool(ff.ok)
        np.testing.assert_allclose(ff.T_c_w.t, 0.0, atol=1e-3)

    def test_find_state_idx_picks_older(self):
        st, t0 = self._init()
        idx = int(vimotion.find_state_idx(st, jnp.asarray(t0 + 100.0)))
        assert float(st.t[idx]) <= t0 + 100.0
        # Newest entry wins for far-future queries.
        assert idx == int((st.head - 1) % CFG.imu_capacity)

    def test_correction_rebases_states(self):
        st, t0 = self._init()
        acc, gyro, t = static_samples(50, t0=t0)
        st = vimotion.imu_feed_batch(CFG, st, acc, gyro, t)
        # Vision says the IMU was actually 1 m along x at t0 (same attitude).
        T_w_i = se3.SE3(so3.identity(), jnp.asarray([1.0, 0.0, 0.0]))
        T_c_w_vision = se3.inverse(T_w_i)  # T_i_c = identity
        st2 = vimotion.correction_from_vision(CFG, st, jnp.asarray(t0), T_c_w_vision, se3.identity())
        i = int((st2.head - 1) % CFG.imu_capacity)
        np.testing.assert_allclose(st2.pos[i], [1.0, 0, 0], atol=0.02)

    def test_second_correction_updates_biases_and_velocity(self):
        """The inter-frame path (second correction with last_vis_* set):
        the bias IIR must move toward the analytic estimates and every
        rebased state's velocity must gain diff_vel (vi_motion.cpp:248-331).

        Setup: static IMU at identity; first correction snaps the chain to
        identity at t1; second correction at t2 = t1 + 0.05 s reports the
        IMU displaced by dx along x and yawed by theta — so vel_vis =
        dx/dt (IMU velocity ~0), acc_est = -vel_vis/dt (identity
        attitude), and gyro_est = q_Bb.xyz/dt ~ [0, 0, -theta/2]/dt (the
        reference's quaternion-xyz-over-dt drift rate)."""
        st, t0 = self._init()
        acc, gyro, t = static_samples(30, t0=t0)
        st = vimotion.imu_feed_batch(CFG, st, acc, gyro, t)
        t1 = t0 + 0.05
        ident = se3.identity()
        st = vimotion.correction_from_vision(
            CFG, st, jnp.asarray(t1), ident, ident)  # first call: snap only
        assert np.allclose(np.asarray(st.bias_acc), 0.0, atol=1e-6)

        dt, dx, theta = 0.05, 0.0005, 0.002
        t2 = t1 + dt
        T_w_i = se3.SE3(so3.from_euler_zyx(jnp.asarray([0.0, 0.0, theta])),
                        jnp.asarray([dx, 0.0, 0.0]))
        vel_before = np.asarray(st.vel)     # donated below — snapshot first
        st2 = vimotion.correction_from_vision(
            CFG, st, jnp.asarray(t2), se3.inverse(T_w_i), ident)

        p3, p4 = CFG.acc_bias_gain, CFG.gyro_bias_gain
        diff_vel = dx / dt                      # vel_vis - vel_imu (~0)
        acc_est = -diff_vel / dt
        gyro_est_z = -(theta / 2.0) / dt
        np.testing.assert_allclose(
            np.asarray(st2.bias_acc), [p3 * acc_est, 0, 0],
            atol=0.25 * abs(p3 * acc_est))
        np.testing.assert_allclose(
            float(st2.bias_gyro[2]), p4 * gyro_est_z,
            atol=0.25 * abs(p4 * gyro_est_z))
        # Rebased states gain the velocity innovation (world frame).
        i = int((st2.head - 1) % CFG.imu_capacity)
        dv = np.asarray(st2.vel[i]) - vel_before[i]
        np.testing.assert_allclose(dv, [diff_vel, 0, 0],
                                   atol=0.25 * diff_vel)

    def test_correction_skips_innovation_when_last_state_evicted(self):
        """If the ring no longer holds any state at/before last_vis_t, the
        correction must take the snap-only path (no velocity innovation, no
        bias update) — the reference gates on viFindStateIdx(t_last)
        succeeding (vi_motion.cpp:229-238)."""
        cfg = VioConfig(imu_capacity=64, init_samples=20)
        st = vimotion.init_state(cfg)
        acc, gyro, t = static_samples(30)
        st = vimotion.imu_feed_batch(cfg, st, acc, gyro, t)
        t0 = float(t[-1])
        ident = se3.identity()
        st = vimotion.correction_from_vision(
            cfg, st, jnp.asarray(t0), ident, ident)
        # Evict everything at/before t0 from the 64-slot ring.
        acc, gyro, t = static_samples(80, t0=t0 + 10.0)
        st = vimotion.imu_feed_batch(cfg, st, acc, gyro, t)
        assert not bool(jnp.any((st.t >= 0) & (st.t <= t0)))
        t2 = float(t[-1])
        T_w_i = se3.SE3(so3.identity(), jnp.asarray([0.5, 0.0, 0.0]))
        vel_before = np.asarray(st.vel)     # donated below — snapshot first
        st2 = vimotion.correction_from_vision(
            cfg, st, jnp.asarray(t2), se3.inverse(T_w_i), ident)
        # Snap happened, but biases untouched and no velocity innovation.
        i = int((st2.head - 1) % cfg.imu_capacity)
        np.testing.assert_allclose(st2.pos[i], [0.5, 0, 0], atol=0.02)
        np.testing.assert_allclose(np.asarray(st2.bias_acc), 0.0, atol=1e-6)
        np.testing.assert_allclose(np.asarray(st2.vel[i]),
                                   vel_before[i], atol=1e-4)

    def test_rp_compensation_blends(self):
        qv = so3.from_euler_zyx(jnp.asarray([0.1, 0.0, 0.7]))
        qi = so3.from_euler_zyx(jnp.asarray([0.0, 0.2, 0.3]))
        out = vimotion.vision_rp_compensation(qv, qi, 0.5)
        rpy = np.asarray(so3.to_euler_zyx(out))
        np.testing.assert_allclose(rpy, [0.05, 0.1, 0.7], atol=1e-5)


class TestMadgwickConvergence:
    def test_converges_from_wrong_attitude(self):
        """Static IMU with true roll 0.2 rad, estimate seeded at identity:
        the accelerometer correction must pull the estimate TOWARD the
        measurement (a sign inversion here once made it diverge)."""
        from flvis_tpu.vio.vimotion import _madgwick_step

        q_true = so3.from_euler_zyx(jnp.asarray([0.2, 0.0, 0.0]))
        acc_body = so3.rotate(so3.conj(q_true), jnp.asarray([0.0, 0.0, 9.81]))
        q = so3.identity()
        for _ in range(600):
            q = _madgwick_step(q, jnp.zeros(3), acc_body, 0.08, 0.005)
        roll = float(so3.to_euler_zyx(q)[0])
        assert abs(roll - 0.2) < 0.03, roll

    def test_feedforward_flags_missing_past_state(self):
        st = vimotion.init_state(CFG)
        acc, gyro, t = static_samples(40, t0=100.0)
        st = vimotion.imu_feed_batch(CFG, st, acc, gyro, t)
        # Query BEFORE every buffered sample: must not claim ok.
        ff = vimotion.get_frame_state(st, jnp.asarray(50.0), se3.identity())
        assert not bool(ff.ok)


class TestFastPropBatch:
    """The vectorized+kernel steady-state path vs the per-sample scan."""

    def _inited_state(self, rng):
        st = vimotion.init_state(CFG)
        acc, gyro, t = static_samples(40, rng=rng, noise=0.02)
        st = vimotion.imu_feed_batch(CFG, st, acc, gyro, t)
        assert bool(st.initialized)
        return st

    def _dynamic_packet(self, rng, P=16, t0=0.3):
        acc = jnp.asarray(
            rng.normal([0.4, -0.2, 9.6], 0.3, (P, 3)).astype(np.float32))
        gyro = jnp.asarray(rng.normal(0.03, 0.15, (P, 3)).astype(np.float32))
        t = jnp.asarray((t0 + 0.005 * np.arange(1, P + 1)).astype(np.float32))
        return acc, gyro, t

    def test_matches_scan_path(self):
        rng = np.random.default_rng(3)
        st = self._inited_state(rng)
        acc, gyro, t = self._dynamic_packet(rng)
        valid = jnp.ones(16, bool)
        fast = vimotion._feed_prop_batch(CFG, st, acc, gyro, t, valid)
        scan = vimotion._feed_scan(CFG, st, acc, gyro, t, valid)
        for f in ("t", "q", "pos", "vel", "head", "count",
                  "bias_acc", "bias_gyro"):
            np.testing.assert_allclose(
                np.asarray(getattr(fast, f)), np.asarray(getattr(scan, f)),
                atol=2e-6, err_msg=f)

    def test_masked_suffix_matches_scan(self):
        rng = np.random.default_rng(4)
        st = self._inited_state(rng)
        acc, gyro, t = self._dynamic_packet(rng)
        valid = jnp.asarray(np.arange(16) < 11)
        fast = vimotion._feed_prop_batch(CFG, st, acc, gyro, t, valid)
        scan = vimotion._feed_scan(CFG, st, acc, gyro, t, valid)
        np.testing.assert_allclose(np.asarray(fast.q), np.asarray(scan.q),
                                   atol=2e-6)
        np.testing.assert_allclose(np.asarray(fast.pos), np.asarray(scan.pos),
                                   atol=2e-6)
        assert int(fast.head) == int(scan.head)

    def test_dispatcher_uses_scan_during_init(self):
        """A mixed init->prop packet must go through the faithful scan:
        samples after the init threshold propagate, before accumulate."""
        st = vimotion.init_state(CFG)
        acc, gyro, t = static_samples(30)          # init_samples=20
        st = vimotion.imu_feed_batch(CFG, st, acc, gyro, t)
        assert bool(st.initialized)
        assert int(st.count) == 30                  # every sample ringed
