"""Multi-device tests on the 8-virtual-device CPU mesh: data-parallel
multi-sequence tracking and landmark-sharded distributed BA."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flvis_tpu.backend import window_ba
from flvis_tpu.config import BackendConfig, FrontendConfig
from flvis_tpu.geometry import camera, se3
from flvis_tpu.parallel import dist_ba, multiseq


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs multi-device mesh")
class TestMultiSeq:
    def test_batched_step_sharded(self):
        from flvis_tpu.io.synthetic import PlanarScene, SceneConfig, orbit_trajectory

        S = 4
        cfg = FrontendConfig(width=256, height=192, num_slots=64, pyramid_levels=3,
                             per_cell=4, min_distance=10.0, margin=12, lk_radius=7,
                             ransac_hypotheses=32)
        mesh = multiseq.make_mesh(S)
        cam1 = camera.make(200.0, 200.0, 128.0, 96.0, 0.12, width=256, height=192)
        cams = jax.tree.map(
            lambda a: jnp.broadcast_to(jnp.asarray(a), (S,) + jnp.shape(jnp.asarray(a))),
            cam1,
        )
        states = multiseq.init_states(cfg, S, mesh)
        scfg = SceneConfig(width=256, height=192, fx=200.0, fy=200.0, cx=128.0,
                           cy=96.0, baseline=0.12)
        scene = PlanarScene(scfg, plane_depth=8.0, seed=0)
        (R, t), (R2, t2) = orbit_trajectory(2, step=0.03)
        il, ir, _ = scene.render(R, t)
        il2, ir2, _ = scene.render(R2, t2)
        # Identical keys so identical inputs give bitwise-identical sequences
        # (distinct keys would vary the RANSAC sampling slightly).
        keys = jnp.tile(jax.random.PRNGKey(0)[None], (S, 1))

        def sharded_imgs(a):
            return multiseq.shard_batch(mesh, jnp.broadcast_to(jnp.asarray(a), (S,) + a.shape))

        cams = multiseq.shard_batch(mesh, cams)
        states, outs = multiseq.track_frame_batch(
            cfg, cams, states, sharded_imgs(il), sharded_imgs(ir), keys)
        states, outs = multiseq.track_frame_batch(
            cfg, cams, states, sharded_imgs(il2), sharded_imgs(ir2), keys)
        st = np.asarray(outs.status)
        assert st.shape == (S,)
        assert np.all(st == 1)
        # All sequences see identical input → identical outputs.
        t_all = np.asarray(outs.T_c_w.t)
        np.testing.assert_allclose(t_all, np.broadcast_to(t_all[0], t_all.shape), atol=1e-5)


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs multi-device mesh")
class TestSystemDP:
    def test_system_chunk_matches_single_sequence(self):
        """FULL-system multi-sequence DP (frontend + window BA + feedback,
        seq-sharded) reproduces the single-sequence fused chunk per
        sequence."""
        from flvis_tpu.io.synthetic import PlanarScene, SceneConfig, orbit_trajectory
        from flvis_tpu.frontend import tracker
        from flvis_tpu.pipeline import runner as runner_m

        S, T = 4, 4
        fcfg = FrontendConfig(width=256, height=192, num_slots=64,
                              pyramid_levels=3, per_cell=4, min_distance=10.0,
                              margin=12, lk_radius=7, ransac_hypotheses=32,
                              kf_bootstrap_every=2)
        bcfg = BackendConfig(window_size=4, max_landmarks=128, min_views=2,
                             iters1=4, iters2=3)
        mesh = multiseq.make_mesh(S)
        cam1 = camera.make(200.0, 200.0, 128.0, 96.0, 0.12,
                           width=256, height=192)
        cams = jax.tree.map(
            lambda a: jnp.broadcast_to(jnp.asarray(a),
                                       (S,) + jnp.shape(jnp.asarray(a))), cam1)
        scfg = SceneConfig(width=256, height=192, fx=200.0, fy=200.0,
                           cx=128.0, cy=96.0, baseline=0.12)
        seq_imgs = []
        for s in range(S):
            scene = PlanarScene(scfg, plane_depth=8.0, seed=s)
            frames = [scene.render(R, t)
                      for (R, t) in orbit_trajectory(T, step=0.04)]
            seq_imgs.append((np.stack([f[0] for f in frames]),
                             np.stack([f[1] for f in frames])))
        imgs0 = jnp.asarray(np.stack([si[0] for si in seq_imgs]))
        imgs1 = jnp.asarray(np.stack([si[1] for si in seq_imgs]))

        fe_b, ba_b, corr_b = multiseq.init_system_states(fcfg, bcfg, S, mesh)
        _, _, _, outs, costs = multiseq.system_chunk_batch(
            fcfg, bcfg, multiseq.shard_batch(mesh, cams), fe_b, ba_b, corr_b,
            multiseq.shard_batch(mesh, imgs0),
            multiseq.shard_batch(mesh, imgs1))
        assert np.asarray(outs.status).shape == (S, T)
        assert costs.shape == (S, T)
        for s in range(S):
            fe0 = tracker.init_state(fcfg)
            ba0 = window_ba.empty(bcfg)
            corr0 = window_ba.null_correction(bcfg)
            _, _, _, ys = runner_m._chunk_fused(
                fcfg, bcfg, cam1, fe0, ba0, corr0, imgs0[s], imgs1[s])
            out_ref = ys[0]
            np.testing.assert_array_equal(np.asarray(outs.status)[s],
                                          np.asarray(out_ref.status))
            np.testing.assert_array_equal(np.asarray(outs.is_keyframe)[s],
                                          np.asarray(out_ref.is_keyframe))
            # Same rounding-order caveat as TestMultiSeqScan (vmap batches
            # the reductions differently): sub-mm agreement expected.
            np.testing.assert_allclose(np.asarray(outs.T_c_w.t)[s],
                                       np.asarray(out_ref.T_c_w.t), atol=1e-3)
        # At least one sequence produced a keyframe (BA actually exercised).
        assert np.asarray(outs.is_keyframe).any()


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs multi-device mesh")
class TestSystemDPVio:
    def test_vio_chunk_matches_single_sequence(self):
        """FULL-VIO-system multi-sequence DP (IMU propagation + feedforward
        priors + RP blend + window BA + bias feedback, seq-sharded)
        reproduces the single-sequence fused VIO chunk per sequence — the
        north-star 'all EuRoC runs at once' workload."""
        from flvis_tpu.config import VioConfig
        from flvis_tpu.frontend import tracker
        from flvis_tpu.io.synthetic import (PlanarScene, SceneConfig,
                                            imu_from_trajectory,
                                            orbit_trajectory)
        from flvis_tpu.pipeline import runner as runner_m
        from flvis_tpu.vio import vimotion

        S, T, P = 4, 4, 16
        fcfg = FrontendConfig(width=256, height=192, num_slots=64,
                              pyramid_levels=3, per_cell=4,
                              min_distance=10.0, margin=12, lk_radius=7,
                              ransac_hypotheses=32, kf_bootstrap_every=2)
        bcfg = BackendConfig(window_size=4, max_landmarks=128, min_views=2,
                             iters1=4, iters2=3)
        vcfg = VioConfig()
        mesh = multiseq.make_mesh(S)
        cam1 = camera.make(200.0, 200.0, 128.0, 96.0, 0.12,
                           width=256, height=192)
        scfg = SceneConfig(width=256, height=192, fx=200.0, fy=200.0,
                           cx=128.0, cy=96.0, baseline=0.12)
        T_i_c1 = se3.identity()

        seqs = []
        for s in range(S):
            scene = PlanarScene(scfg, plane_depth=8.0, seed=s)
            poses = orbit_trajectory(T, step=0.04)
            frames = [scene.render(R, t) for (R, t) in poses]
            t_imu, gyro, acc, frame_t = imu_from_trajectory(poses, fps=20.0)
            accs, gyros, imuts = [], [], []
            prev = -np.inf
            for ft in frame_t:
                m = (t_imu > prev) & (t_imu <= ft)
                accs.append(acc[m]); gyros.append(gyro[m])
                imuts.append(t_imu[m]); prev = ft
            a_p, g_p, t_p, v_p = runner_m.pack_imu_frames(
                accs, gyros, imuts, P)
            seqs.append((np.stack([f[0] for f in frames]),
                         np.stack([f[1] for f in frames]),
                         np.asarray(frame_t, np.float32),
                         a_p, g_p, t_p, v_p))

        stack = lambda i: jnp.asarray(np.stack([x[i] for x in seqs]))
        sh = lambda a: multiseq.shard_batch(mesh, a)
        cams = sh(jax.tree.map(
            lambda a: jnp.broadcast_to(jnp.asarray(a),
                                       (S,) + jnp.shape(jnp.asarray(a))),
            cam1))
        T_i_cs = sh(jax.tree.map(
            lambda a: jnp.broadcast_to(a, (S,) + a.shape), T_i_c1))
        fe_b, ba_b, corr_b, vio_b = multiseq.init_system_states(
            fcfg, bcfg, S, mesh, vcfg=vcfg)
        _, _, _, _, outs, costs = multiseq.system_chunk_batch_vio(
            fcfg, bcfg, vcfg, cams, T_i_cs, fe_b, ba_b, vio_b, corr_b,
            sh(stack(0)), sh(stack(1)), sh(stack(2)), sh(stack(3)),
            sh(stack(4)), sh(stack(5)), sh(stack(6)))
        assert np.asarray(outs.status).shape == (S, T)

        for s in range(S):
            (i0, i1, ts_f, a_p, g_p, t_p, v_p) = seqs[s]
            _, _, _, _, ys = runner_m._chunk_fused_vio(
                fcfg, bcfg, vcfg, cam1, T_i_c1, tracker.init_state(fcfg),
                window_ba.empty(bcfg), vimotion.init_state(vcfg),
                window_ba.null_correction(bcfg), jnp.asarray(i0),
                jnp.asarray(i1), jnp.asarray(ts_f), jnp.asarray(a_p),
                jnp.asarray(g_p), jnp.asarray(t_p), jnp.asarray(v_p))
            out_ref = ys[0]
            np.testing.assert_array_equal(np.asarray(outs.status)[s],
                                          np.asarray(out_ref.status))
            np.testing.assert_array_equal(np.asarray(outs.is_keyframe)[s],
                                          np.asarray(out_ref.is_keyframe))
            # Same vmap reduction-order caveat as TestSystemDP: sub-mm.
            np.testing.assert_allclose(np.asarray(outs.T_c_w.t)[s],
                                       np.asarray(out_ref.T_c_w.t),
                                       atol=2e-3)


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs multi-device mesh")
class TestSystemDPBaCadence:
    def test_ba_every_2_stays_close_to_per_keyframe(self):
        """Deferred-cadence DP (ba_every=2): the solve runs on a scan-
        uniform schedule instead of per frame (the vmap cond→select tax),
        with corrections ≤2 frames late.  Trajectories must stay sub-mm
        from the per-keyframe path on the synthetic scene."""
        from flvis_tpu.io.synthetic import (PlanarScene, SceneConfig,
                                            orbit_trajectory)

        S, T = 4, 6
        fcfg = FrontendConfig(width=256, height=192, num_slots=64,
                              pyramid_levels=3, per_cell=4,
                              min_distance=10.0, margin=12, lk_radius=7,
                              ransac_hypotheses=32, kf_bootstrap_every=2)
        bcfg = BackendConfig(window_size=4, max_landmarks=128, min_views=2,
                             iters1=4, iters2=3)
        mesh = multiseq.make_mesh(S)
        cam1 = camera.make(200.0, 200.0, 128.0, 96.0, 0.12,
                           width=256, height=192)
        cams = jax.tree.map(
            lambda a: jnp.broadcast_to(jnp.asarray(a),
                                       (S,) + jnp.shape(jnp.asarray(a))),
            cam1)
        scfg = SceneConfig(width=256, height=192, fx=200.0, fy=200.0,
                           cx=128.0, cy=96.0, baseline=0.12)
        seq_imgs = []
        for s in range(S):
            scene = PlanarScene(scfg, plane_depth=8.0, seed=s)
            frames = [scene.render(R, t)
                      for (R, t) in orbit_trajectory(T, step=0.04)]
            seq_imgs.append((np.stack([f[0] for f in frames]),
                             np.stack([f[1] for f in frames])))
        imgs0 = multiseq.shard_batch(
            mesh, jnp.asarray(np.stack([si[0] for si in seq_imgs])))
        imgs1 = multiseq.shard_batch(
            mesh, jnp.asarray(np.stack([si[1] for si in seq_imgs])))
        cams = multiseq.shard_batch(mesh, cams)

        outs_by_cadence = {}
        for n in (1, 2):
            fe_b, ba_b, corr_b = multiseq.init_system_states(
                fcfg, bcfg, S, mesh)
            _, _, _, outs, costs = multiseq.system_chunk_batch(
                fcfg, bcfg, cams, fe_b, ba_b, corr_b, imgs0, imgs1,
                ba_every=n)
            outs_by_cadence[n] = (jax.tree.map(np.asarray, outs),
                                  np.asarray(costs))
        ref, _ = outs_by_cadence[1]
        got, costs2 = outs_by_cadence[2]
        np.testing.assert_array_equal(got.status, ref.status)
        np.testing.assert_array_equal(got.is_keyframe, ref.is_keyframe)
        # Corrections arriving ≤2 frames late shift poses a few mm on this
        # scene (max observed 4 mm at 0.04 m/frame); status and keyframe
        # decisions stay identical.
        np.testing.assert_allclose(got.T_c_w.t, ref.T_c_w.t, atol=5e-3)
        # The solve really is gated to the cadence frames.
        assert (costs2[:, 0::2] == 0).all()
        assert np.isfinite(costs2).all()

    def test_vio_ba_every_2_stays_close_to_per_keyframe(self):
        """Same deferred-cadence contract for the FULL-VIO DP variant
        (system_chunk_batch_vio ba_every=2) — the north-star 'all EuRoC
        runs at once' workload pays the cond→select Schur tax every frame
        at per-keyframe cadence; the scan-uniform schedule must hold
        status/keyframe decisions identical and trajectories sub-5 mm."""
        from flvis_tpu.config import VioConfig
        from flvis_tpu.io.synthetic import (PlanarScene, SceneConfig,
                                            imu_from_trajectory,
                                            orbit_trajectory)
        from flvis_tpu.pipeline import runner as runner_m

        S, T, P = 4, 6, 16
        fcfg = FrontendConfig(width=256, height=192, num_slots=64,
                              pyramid_levels=3, per_cell=4,
                              min_distance=10.0, margin=12, lk_radius=7,
                              ransac_hypotheses=32, kf_bootstrap_every=2)
        bcfg = BackendConfig(window_size=4, max_landmarks=128, min_views=2,
                             iters1=4, iters2=3)
        vcfg = VioConfig()
        mesh = multiseq.make_mesh(S)
        cam1 = camera.make(200.0, 200.0, 128.0, 96.0, 0.12,
                           width=256, height=192)
        scfg = SceneConfig(width=256, height=192, fx=200.0, fy=200.0,
                           cx=128.0, cy=96.0, baseline=0.12)
        seqs = []
        for s in range(S):
            scene = PlanarScene(scfg, plane_depth=8.0, seed=s)
            poses = orbit_trajectory(T, step=0.04)
            frames = [scene.render(R, t) for (R, t) in poses]
            t_imu, gyro, acc, frame_t = imu_from_trajectory(poses, fps=20.0)
            accs, gyros, imuts = [], [], []
            prev = -np.inf
            for ft in frame_t:
                m = (t_imu > prev) & (t_imu <= ft)
                accs.append(acc[m]); gyros.append(gyro[m])
                imuts.append(t_imu[m]); prev = ft
            a_p, g_p, t_p, v_p = runner_m.pack_imu_frames(
                accs, gyros, imuts, P)
            seqs.append((np.stack([f[0] for f in frames]),
                         np.stack([f[1] for f in frames]),
                         np.asarray(frame_t, np.float32),
                         a_p, g_p, t_p, v_p))
        stack = lambda i: jnp.asarray(np.stack([x[i] for x in seqs]))
        sh = lambda a: multiseq.shard_batch(mesh, a)
        cams = sh(jax.tree.map(
            lambda a: jnp.broadcast_to(jnp.asarray(a),
                                       (S,) + jnp.shape(jnp.asarray(a))),
            cam1))
        T_i_cs = sh(jax.tree.map(
            lambda a: jnp.broadcast_to(a, (S,) + a.shape), se3.identity()))
        args = tuple(sh(stack(i)) for i in range(7))

        outs_by_cadence = {}
        for n in (1, 2):
            fe_b, ba_b, corr_b, vio_b = multiseq.init_system_states(
                fcfg, bcfg, S, mesh, vcfg=vcfg)
            _, _, _, _, outs, costs = multiseq.system_chunk_batch_vio(
                fcfg, bcfg, vcfg, cams, T_i_cs, fe_b, ba_b, vio_b, corr_b,
                *args, ba_every=n)
            outs_by_cadence[n] = (jax.tree.map(np.asarray, outs),
                                  np.asarray(costs))
        ref, _ = outs_by_cadence[1]
        got, costs2 = outs_by_cadence[2]
        np.testing.assert_array_equal(got.status, ref.status)
        np.testing.assert_array_equal(got.is_keyframe, ref.is_keyframe)
        np.testing.assert_allclose(got.T_c_w.t, ref.T_c_w.t, atol=5e-3)
        assert (costs2[:, 0::2] == 0).all()
        assert np.isfinite(costs2).all()


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs multi-device mesh")
class TestDistBA:
    def test_sharded_matches_single_device(self, rng):
        import tests.test_window_ba as twb

        cfg = BackendConfig(window_size=5, max_landmarks=128, min_views=3,
                            iters1=6, iters2=4)
        cam = twb.CAM
        pts = twb.make_world(rng)
        st = window_ba.empty(cfg)
        for i in range(5):
            st = window_ba.add_keyframe(
                cfg, st, twb.packet(i, pts, rng, pose_noise=0.0 if i == 0 else 0.02,
                                    pw_noise=0.1))
        # Reference: single-device optimize.
        res = window_ba.optimize(cfg, cam, st)
        # Sharded: same state over a 4-device lm mesh.
        mesh = dist_ba.make_lm_mesh(4)
        st_sh = dist_ba.shard_window_state(mesh, st)
        poses, lm_pw, cost = dist_ba.optimize_sharded(cfg, mesh, cam, st_sh)
        np.testing.assert_allclose(np.asarray(poses.t), np.asarray(res.state.kf_t),
                                   atol=5e-4)
        np.testing.assert_allclose(np.asarray(lm_pw), np.asarray(res.state.lm_pw),
                                   atol=5e-3)


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs multi-device mesh")
class TestShardedChunk:
    def test_chunk_with_sharded_ba_matches_single_device(self):
        """The fused frontend+backend chunk with the BA landmark axis
        sharded over a 4-device lm mesh (dist_ba.chunk_fused_sharded):
        replicated tracker, psum-reduced pose system, all_gather-ed
        Correction — must reproduce the single-device chunk."""
        from flvis_tpu.frontend import tracker
        from flvis_tpu.io.synthetic import MultiPlaneScene, SceneConfig, orbit_trajectory
        from flvis_tpu.pipeline import runner as runner_m

        T = 6
        fcfg = FrontendConfig(width=256, height=192, num_slots=64,
                              pyramid_levels=3, per_cell=4, min_distance=10.0,
                              margin=12, lk_radius=7, ransac_hypotheses=32,
                              kf_bootstrap_every=2)
        bcfg = BackendConfig(window_size=4, max_landmarks=128, min_views=2,
                             iters1=4, iters2=3)
        scfg = SceneConfig(width=256, height=192, fx=200.0, fy=200.0,
                           cx=128.0, cy=96.0, baseline=0.12)
        cam = camera.make(200.0, 200.0, 128.0, 96.0, 0.12,
                          width=256, height=192)
        scene = MultiPlaneScene(scfg, seed=0)
        frames = [scene.render(R, t) for (R, t) in orbit_trajectory(T, step=0.04)]
        i0 = jnp.asarray(np.stack([f[0] for f in frames]))
        i1 = jnp.asarray(np.stack([f[1] for f in frames]))

        _, ba_r, _, ys = runner_m._chunk_fused(
            fcfg, bcfg, cam, tracker.init_state(fcfg), window_ba.empty(bcfg),
            window_ba.null_correction(bcfg), i0, i1)
        out_ref = ys[0]

        mesh = dist_ba.make_lm_mesh(4)
        ba_sh = dist_ba.shard_window_state(mesh, window_ba.empty(bcfg))
        c_sh = dist_ba.shard_correction(mesh, window_ba.null_correction(bcfg))
        _, ba_s, _, (outs, costs) = dist_ba.chunk_fused_sharded(
            fcfg, bcfg, mesh, cam, tracker.init_state(fcfg), ba_sh, c_sh,
            i0, i1)

        np.testing.assert_array_equal(np.asarray(outs.status),
                                      np.asarray(out_ref.status))
        np.testing.assert_array_equal(np.asarray(outs.is_keyframe),
                                      np.asarray(out_ref.is_keyframe))
        np.testing.assert_allclose(np.asarray(outs.T_c_w.t),
                                   np.asarray(out_ref.T_c_w.t), atol=5e-4)
        # Same landmark SET with matching refined positions (slot order
        # differs: the sharded path hash-partitions allocation by id).
        id_ref = np.asarray(ba_r.lm_id)[np.asarray(ba_r.lm_valid)]
        id_sh = np.asarray(ba_s.lm_id)[np.asarray(ba_s.lm_valid)]
        assert set(id_ref) == set(id_sh) and len(id_ref) > 0
        m_ref = dict(zip(id_ref,
                         np.asarray(ba_r.lm_pw)[np.asarray(ba_r.lm_valid)]))
        m_sh = dict(zip(id_sh,
                        np.asarray(ba_s.lm_pw)[np.asarray(ba_s.lm_valid)]))
        dmax = max(np.abs(m_ref[i] - m_sh[i]).max() for i in id_ref)
        assert dmax < 5e-3, dmax


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs multi-device mesh")
class TestMultiHost:
    """Degenerate single-process checks of the multi-host (DCN) layer:
    the same code paths a 2-host launch uses, minus the second process."""

    def test_initialize_single_process_is_noop(self):
        from flvis_tpu.parallel import multihost

        multihost.initialize(num_processes=1)       # must not touch runtime
        assert multihost.process_count() == 1
        assert multihost.is_primary()

    def test_initialize_requires_coordinator(self):
        from flvis_tpu.parallel import multihost

        with pytest.raises(ValueError):
            multihost.initialize(num_processes=2, process_id=0)

    def test_host_slice_covers_all_seqs_one_process(self):
        from flvis_tpu.parallel import multihost

        mesh = multiseq.make_mesh(8)
        sl = multihost.host_sequence_slice(16, mesh)
        assert (sl.start, sl.stop) == (0, 16)
        with pytest.raises(ValueError):
            multihost.host_sequence_slice(10, mesh)  # not divisible

    def test_global_batch_feeds_system_dp(self):
        """make_global_batch-placed data drives the full-system DP program
        (the exact multi-host steady-state path, process_count=1)."""
        from flvis_tpu.io.synthetic import PlanarScene, SceneConfig, orbit_trajectory
        from flvis_tpu.parallel import multihost

        S, T = 4, 2
        fcfg = FrontendConfig(width=256, height=192, num_slots=64,
                              pyramid_levels=3, per_cell=4, min_distance=10.0,
                              margin=12, lk_radius=7, ransac_hypotheses=32)
        bcfg = BackendConfig(window_size=4, max_landmarks=128, min_views=2,
                             iters1=4, iters2=3)
        mesh = multiseq.make_mesh(S)
        cam1 = camera.make(200.0, 200.0, 128.0, 96.0, 0.12,
                           width=256, height=192)
        scfg = SceneConfig(width=256, height=192, fx=200.0, fy=200.0,
                           cx=128.0, cy=96.0, baseline=0.12)
        sl = multihost.host_sequence_slice(S, mesh)
        seqs = []
        for s in range(S)[sl]:
            scene = PlanarScene(scfg, plane_depth=8.0, seed=s)
            frames = [scene.render(R, t)
                      for (R, t) in orbit_trajectory(T, step=0.04)]
            seqs.append((np.stack([f[0] for f in frames]),
                         np.stack([f[1] for f in frames])))
        local0 = np.stack([x[0] for x in seqs])
        local1 = np.stack([x[1] for x in seqs])
        imgs0, imgs1 = multihost.make_global_batch(mesh, (local0, local1))
        assert imgs0.shape == (S, T, 192, 256)
        cams = multihost.make_global_batch(
            mesh, jax.tree.map(
                lambda a: np.broadcast_to(np.asarray(a),
                                          (S,) + np.shape(np.asarray(a))),
                cam1))
        fe_b, ba_b, corr_b = multiseq.init_system_states(fcfg, bcfg, S, mesh)
        _, _, _, outs, _ = multiseq.system_chunk_batch(
            fcfg, bcfg, cams, fe_b, ba_b, corr_b, imgs0, imgs1)
        st = np.asarray(outs.status)
        assert st.shape == (S, T) and (st >= 0).all()


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs multi-device mesh")
class TestDistLoop:
    def _db(self, rng, K=64, V=128):
        db = rng.uniform(0, 1, (K, V)).astype(np.float32)
        db /= np.abs(db).sum(axis=1, keepdims=True)
        return jnp.asarray(db)

    def test_sharded_scores_match_dense(self, rng):
        from flvis_tpu.loop import bow
        from flvis_tpu.parallel import dist_loop

        mesh = dist_loop.make_kf_mesh(4)
        db = self._db(rng)
        valid = jnp.asarray(np.arange(64) < 40)
        db_sh, valid_sh = dist_loop.shard_db(mesh, db, valid)
        q = db[7]
        ref = np.asarray(bow.score_database(q, db, valid))
        got = np.asarray(dist_loop.score_database_sharded(mesh, q, db_sh, valid_sh))
        np.testing.assert_allclose(got, ref, atol=1e-6)

    def test_best_candidate_reduction(self, rng):
        from flvis_tpu.parallel import dist_loop

        mesh = dist_loop.make_kf_mesh(4)
        db = self._db(rng)
        valid = jnp.ones(64, bool)
        # Eligibility window [0, 30) — the temporal gate.
        cand = jnp.asarray(np.arange(64) < 30)
        db_sh, valid_sh = dist_loop.shard_db(mesh, db, valid)
        q = db[37]
        v, i = dist_loop.best_candidate_sharded(mesh, q, db_sh, valid_sh, cand)
        s = 1.0 - 0.5 * np.abs(np.asarray(db) - np.asarray(q)).sum(axis=1)
        s[30:] = -np.inf
        assert int(i) == int(np.argmax(s))
        np.testing.assert_allclose(float(v), float(s[int(np.argmax(s))]), atol=1e-6)

    def test_set_row_preserves_sharding(self, rng):
        from flvis_tpu.parallel import dist_loop

        mesh = dist_loop.make_kf_mesh(4)
        db = jnp.zeros((64, 128), jnp.float32)
        db_sh, _ = dist_loop.shard_db(mesh, db, jnp.zeros(64, bool))
        row = jnp.asarray(rng.uniform(0, 1, 128).astype(np.float32))
        db_sh = dist_loop.set_row(mesh, db_sh, jnp.asarray(5), row)
        np.testing.assert_allclose(np.asarray(db_sh[5]), np.asarray(row), atol=0)
        assert np.asarray(db_sh[6]).sum() == 0


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs multi-device mesh")
class TestMultiSeqScan:
    def test_vmap_scan_matches_per_sequence(self):
        from flvis_tpu.frontend import tracker
        from flvis_tpu.io.synthetic import PlanarScene, SceneConfig, orbit_trajectory

        S, T = 4, 3
        cfg = FrontendConfig(width=256, height=192, num_slots=64, pyramid_levels=3,
                             per_cell=4, min_distance=10.0, margin=12, lk_radius=7,
                             ransac_hypotheses=32)
        mesh = multiseq.make_mesh(S)
        cam1 = camera.make(200.0, 200.0, 128.0, 96.0, 0.12, width=256, height=192)
        cams = jax.tree.map(
            lambda a: jnp.broadcast_to(jnp.asarray(a), (S,) + jnp.shape(jnp.asarray(a))),
            cam1)
        scfg = SceneConfig(width=256, height=192, fx=200.0, fy=200.0, cx=128.0,
                           cy=96.0, baseline=0.12)
        # Distinct scene per sequence.
        seq_imgs = []
        for s in range(S):
            scene = PlanarScene(scfg, plane_depth=8.0, seed=s)
            frames = [scene.render(R, t) for (R, t) in orbit_trajectory(T, step=0.03)]
            seq_imgs.append((np.stack([f[0] for f in frames]),
                             np.stack([f[1] for f in frames])))
        imgs0 = jnp.asarray(np.stack([si[0] for si in seq_imgs]))
        imgs1 = jnp.asarray(np.stack([si[1] for si in seq_imgs]))

        states = multiseq.init_states(cfg, S, mesh)
        states2, outs = multiseq.track_frames_scan_batch(
            cfg, multiseq.shard_batch(mesh, cams), states,
            multiseq.shard_batch(mesh, imgs0), multiseq.shard_batch(mesh, imgs1))
        assert np.asarray(outs.status).shape == (S, T)
        # Per-sequence reference: single-sequence scan.
        for s in range(S):
            st_ref, out_ref = tracker.track_frames_scan(
                cfg, cam1, tracker.init_state(cfg), imgs0[s], imgs1[s])
            # vmap batches the LK selection einsums / QR dots differently
            # from the single-sequence program, so reduction order (and thus
            # f32 rounding) differs; additionally the LK while-loop early
            # exit runs in LOCK-STEP across the batch under vmap, so a
            # sequence can receive up to one extra GN iteration pair that
            # its solo run skipped.  Sub-0.5 mm agreement is the realistic
            # contract for bitwise-different-but-equivalent programs.
            np.testing.assert_allclose(np.asarray(outs.T_c_w.t)[s],
                                       np.asarray(out_ref.T_c_w.t), atol=5e-4)
            np.testing.assert_array_equal(np.asarray(outs.status)[s],
                                          np.asarray(out_ref.status))
