"""Sliding-window BA tests: window bookkeeping and Schur-LM convergence."""

import jax.numpy as jnp
import numpy as np

from flvis_tpu.backend import window_ba
from flvis_tpu.config import BackendConfig
from flvis_tpu.geometry import camera, se3, so3

CFG = BackendConfig(window_size=5, max_landmarks=128, min_views=3, iters1=12, iters2=8)
CAM = camera.make(400.0, 400.0, 256.0, 192.0, baseline=0.2, width=512, height=384)


def make_world(rng, n_lm=60):
    return rng.uniform([-4, -3, 6], [4, 3, 14], size=(n_lm, 3)).astype(np.float32)


def gt_pose(i):
    """Camera moving along +x, looking forward."""
    q = so3.exp(jnp.asarray([0.0, 0.002 * i, 0.0]))
    C = jnp.asarray([0.25 * i, 0.0, 0.0])
    t = -so3.rotate(q, C)
    return se3.SE3(q, t)


def packet(i, pts_w, rng, noise=0.0, pose_noise=0.0, pw_noise=0.0, stereo=True):
    T = gt_pose(i)
    pc = se3.transform_points(T, jnp.asarray(pts_w))
    uvr = camera.project_stereo(CAM, pc)
    uv = uvr[:, :2]
    ur = uvr[:, 2]
    if noise:
        uv = uv + rng.normal(scale=noise, size=uv.shape).astype(np.float32)
        ur = ur + rng.normal(scale=noise, size=ur.shape).astype(np.float32)
    q, t = T.q, T.t
    if pose_noise:
        d = se3.exp(jnp.asarray(rng.normal(scale=pose_noise, size=6).astype(np.float32)))
        q, t = se3.compose(d, T).q, se3.compose(d, T).t
    pw = jnp.asarray(pts_w)
    if pw_noise:
        pw = pw + rng.normal(scale=pw_noise, size=pw.shape).astype(np.float32)
    n = len(pts_w)
    return window_ba.KeyframePacket(
        frame_id=jnp.asarray(i, jnp.int32), q=q, t=t,
        lm_id=jnp.arange(100, 100 + n, dtype=jnp.int32),
        lm_uv=uv, lm_ur=ur, lm_ur_mask=jnp.full(n, stereo),
        lm_pw=pw, lm_mask=jnp.ones(n, bool),
    )


class TestWindowBookkeeping:
    def test_add_matches_ids(self, rng):
        pts = make_world(rng, 20)
        st = window_ba.empty(CFG)
        st = window_ba.add_keyframe(CFG, st, packet(0, pts, rng))
        st = window_ba.add_keyframe(CFG, st, packet(1, pts, rng))
        assert int(jnp.sum(st.lm_valid)) == 20          # same ids → same slots
        assert int(jnp.sum(st.obs_valid)) == 40         # 2 KFs × 20 obs
        assert int(st.count) == 2

    def test_ring_slide_frees_orphans(self, rng):
        pts_a = make_world(rng, 10)
        pts_b = make_world(rng, 10)
        st = window_ba.empty(CFG)
        # Fill the 5-KF window with landmarks A.
        for i in range(5):
            st = window_ba.add_keyframe(CFG, st, packet(i, pts_a, rng))
        assert int(jnp.sum(st.lm_valid)) == 10
        # Slide in 5 KFs that only see landmarks B (different ids).
        for i in range(5, 10):
            p = packet(i, pts_b, rng)
            p = p._replace(lm_id=jnp.arange(500, 510, dtype=jnp.int32))
            st = window_ba.add_keyframe(CFG, st, p)
        # All A-landmarks lost every observation → freed.
        live_ids = np.asarray(st.lm_id)[np.asarray(st.lm_valid)]
        assert np.all(live_ids >= 500)
        assert int(jnp.sum(st.lm_valid)) == 10

    def test_capacity_overflow_drops_extras(self, rng):
        small = BackendConfig(window_size=3, max_landmarks=16)
        pts = make_world(rng, 30)
        st = window_ba.empty(small)
        st = window_ba.add_keyframe(small, st, packet(0, pts, rng))
        assert int(jnp.sum(st.lm_valid)) == 16  # capped, no crash


class TestWindowOptimize:
    def test_noop_until_three_kfs(self, rng):
        pts = make_world(rng)
        st = window_ba.empty(CFG)
        st = window_ba.add_keyframe(CFG, st, packet(0, pts, rng))
        res = window_ba.optimize(CFG, CAM, st)
        assert not bool(res.correction.valid)

    def test_converges_from_noisy_init(self, rng):
        pts = make_world(rng)
        st = window_ba.empty(CFG)
        for i in range(5):
            # Perfect observations; noisy initial poses (except KF0) and points.
            p = packet(i, pts, rng, noise=0.0,
                       pose_noise=0.0 if i == 0 else 0.02, pw_noise=0.1)
            st = window_ba.add_keyframe(CFG, st, p)
        res = window_ba.optimize(CFG, CAM, st)
        assert bool(res.correction.valid)
        st2 = res.state
        # Window poses should match ground truth.
        errs = []
        for slot in range(5):
            fid = int(st2.kf_frame_id[slot])
            T_est = se3.SE3(st2.kf_q[slot], st2.kf_t[slot])
            dt, dr = se3.distance(T_est, gt_pose(fid))
            errs.append((float(dt), float(dr)))
        max_dt = max(e[0] for e in errs)
        max_dr = max(e[1] for e in errs)
        assert max_dt < 5e-3, errs
        assert max_dr < 2e-3, errs
        # Landmarks should be recovered too.
        lm_err = np.linalg.norm(np.asarray(st2.lm_pw)[np.asarray(st2.lm_valid)] - pts, axis=-1)
        assert lm_err.max() < 0.03

    def test_robust_to_outlier_observations(self, rng):
        pts = make_world(rng)
        st = window_ba.empty(CFG)
        for i in range(5):
            p = packet(i, pts, rng, noise=0.3, pose_noise=0.0 if i == 0 else 0.01,
                       pw_noise=0.05)
            if i == 3:  # corrupt a few observations hard
                uv = np.array(p.lm_uv)
                uv[:5] += 60.0
                p = p._replace(lm_uv=jnp.asarray(uv))
            st = window_ba.add_keyframe(CFG, st, p)
        res = window_ba.optimize(CFG, CAM, st)
        st2 = res.state
        for slot in range(5):
            fid = int(st2.kf_frame_id[slot])
            T_est = se3.SE3(st2.kf_q[slot], st2.kf_t[slot])
            dt, _ = se3.distance(T_est, gt_pose(fid))
            assert float(dt) < 0.02

    def test_correction_exports_multiview(self, rng):
        pts = make_world(rng)
        st = window_ba.empty(CFG)
        for i in range(5):
            st = window_ba.add_keyframe(CFG, st, packet(i, pts, rng, pw_noise=0.05))
        res = window_ba.optimize(CFG, CAM, st)
        corr = res.correction
        assert bool(corr.valid)
        assert int(corr.frame_id) == 4  # newest
        assert int(jnp.sum(corr.lm_mask)) == len(pts)  # all seen 5 ≥ 3 times

    def test_reset(self, rng):
        pts = make_world(rng)
        st = window_ba.empty(CFG)
        st = window_ba.add_keyframe(CFG, st, packet(0, pts, rng))
        st = window_ba.reset(CFG, st)
        assert int(st.count) == 0 and int(jnp.sum(st.lm_valid)) == 0
