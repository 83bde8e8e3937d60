"""Integration test: full frontend + sliding-window-BA pipeline on synthetic
stereo with backend feedback enabled."""

import numpy as np
import pytest

from flvis_tpu.config import BackendConfig, FrontendConfig, SystemConfig
from flvis_tpu.geometry import camera
from flvis_tpu.io.synthetic import (MultiPlaneScene, PlanarScene, SceneConfig,
                                    orbit_trajectory)
from flvis_tpu.pipeline.runner import SlamSystem


@pytest.fixture(scope="module")
def pipeline_run():
    scfg = SceneConfig()
    scene = PlanarScene(scfg, plane_depth=8.0, seed=4)
    poses = orbit_trajectory(30, step=0.03)
    cfg = SystemConfig(
        frontend=FrontendConfig(width=scfg.width, height=scfg.height, num_slots=128,
                                pyramid_levels=3, per_cell=8, min_distance=12.0,
                                margin=22),
        backend=BackendConfig(window_size=5, max_landmarks=256, iters1=8, iters2=4),
    )
    cam = camera.make(scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline,
                      width=scfg.width, height=scfg.height)
    sys_ = SlamSystem(cfg, cam)
    outs = [sys_.process_frame(*scene.render(R, t)[:2]) for (R, t) in poses]
    return poses, sys_, outs


class TestPipeline:
    def test_runs_and_keyframes(self, pipeline_run):
        poses, sys_, outs = pipeline_run
        assert len(sys_.keyframes) >= 5
        assert all(int(o.status) == 1 for o in outs)

    def test_ate_with_backend(self, pipeline_run):
        poses, sys_, outs = pipeline_run
        C_est = sys_.trajectory_cam_centers()
        C_gt = np.asarray([-R.T @ t for (R, t) in poses])
        ate = np.sqrt(np.mean(np.sum((C_est - C_gt) ** 2, axis=-1)))
        path = 0.03 * len(poses)
        assert ate < 0.02 * path + 0.01, f"ATE {ate:.4f} m over {path:.2f} m"

    def test_ba_cost_finite(self, pipeline_run):
        _, sys_, _ = pipeline_run
        costs = [float(c) for c in sys_.ba_costs]
        assert all(np.isfinite(c) for c in costs)


class TestChunkReplay:
    def test_process_frames_matches_accuracy(self):
        """The lax.scan chunked replay path tracks the same synthetic
        sequence within the same ATE bound as the stepwise path."""
        scfg = SceneConfig()
        scene = PlanarScene(scfg, plane_depth=8.0, seed=4)
        poses = orbit_trajectory(24, step=0.03)
        cfg = SystemConfig(
            frontend=FrontendConfig(width=scfg.width, height=scfg.height,
                                    num_slots=128, pyramid_levels=3, per_cell=8,
                                    min_distance=12.0, margin=22),
            backend=BackendConfig(window_size=5, max_landmarks=256,
                                  iters1=8, iters2=4),
        )
        cam = camera.make(scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline,
                          width=scfg.width, height=scfg.height)
        sys_ = SlamSystem(cfg, cam)
        frames = [scene.render(R, t) for (R, t) in poses]
        chunk = 8
        for c0 in range(0, len(frames), chunk):
            batch = frames[c0:c0 + chunk]
            i0 = np.stack([b[0] for b in batch])
            i1 = np.stack([b[1] for b in batch])
            outs = sys_.process_frames(i0, i1)
            assert outs.status.shape[0] == len(batch)
        assert len(sys_.trajectory) == len(poses)
        assert len(sys_.keyframes) >= 4
        # Every frame after init must be TRACKING.
        C_est = sys_.trajectory_cam_centers()
        C_gt = np.asarray([-R.T @ t for (R, t) in poses])
        ate = np.sqrt(np.mean(np.sum((C_est - C_gt) ** 2, axis=-1)))
        path = 0.03 * len(poses)
        assert ate < 0.02 * path + 0.01, f"ATE {ate:.4f} m over {path:.2f} m"

    def test_chunked_loop_path_deferred_gate(self):
        """Chunked replay with the loop node on: the whole chunk's keyframes
        ingest through ONE batched device program, the candidate gate
        resolves one chunk late (bundled fetch), and a revisit still closes
        the loop after flush_loop()."""
        scfg = SceneConfig(width=256, height=192, fx=200.0, fy=200.0,
                           cx=128.0, cy=96.0, baseline=0.12)
        scene = PlanarScene(scfg, plane_depth=8.0, seed=11)
        from flvis_tpu.config import LoopConfig

        cfg = SystemConfig(
            frontend=FrontendConfig(width=scfg.width, height=scfg.height,
                                    num_slots=128, pyramid_levels=3,
                                    per_cell=8, min_distance=12.0, margin=22,
                                    kf_min_trans=0.04),
            backend=BackendConfig(window_size=5, max_landmarks=256,
                                  iters1=8, iters2=4),
            loop=LoopConfig(max_keyframes=64, num_orb_features=128,
                            vocab_words=128, kf_start=10, kf_dist=8,
                            kf_max_dist=64, nkf_closest=2, min_pts=12,
                            min_score=0.03, ratio_ransac=0.3,
                            seq_edge_successors=3),
        )
        cam = camera.make(scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline,
                          width=scfg.width, height=scfg.height)
        sys_ = SlamSystem(cfg, cam, use_loop=True)
        # Out-and-back pan: the last frames revisit the first viewpoints.
        n = 24
        half = n // 2
        xs = list(np.linspace(0, 0.9, half)) + \
            list(np.linspace(0.9, 0.02, n - half))
        frames = []
        for x in xs:
            R = np.eye(3)
            t = -R @ np.asarray([x, 0.0, 0.0])
            frames.append(scene.render(R, t))
        for c0 in range(0, n, 8):
            batch = frames[c0:c0 + 8]
            sys_.process_frames(np.stack([b[0] for b in batch]),
                                np.stack([b[1] for b in batch]))
            # Loop store tracks the keyframe stream exactly.
            assert sys_.loop_closer.count == len(sys_.keyframes)
        assert sys_.loop_closer.count >= 12
        sys_.flush_loop()
        assert sys_._pending_gate is None
        closures = sys_.loop_closer.closures
        assert len(closures) >= 1, "revisit not detected via chunked path"
        assert closures[0].kf_j - closures[0].kf_i >= 8

    def test_loop_node_on_second_device(self):
        """loop_device: the whole loop node (store + ingest + gate + PGO)
        lives on a second chip and its programs dispatch there (the
        reference's loop nodelet runs on spare CPU cores; async dispatch to
        another device is the equivalent here).  Results must match the
        single-device loop path exactly."""
        import jax

        if len(jax.devices()) < 2:
            pytest.skip("needs 2 devices")
        from flvis_tpu.config import LoopConfig

        scfg = SceneConfig(width=256, height=192, fx=200.0, fy=200.0,
                           cx=128.0, cy=96.0, baseline=0.12)
        scene = PlanarScene(scfg, plane_depth=8.0, seed=11)
        cfg = SystemConfig(
            frontend=FrontendConfig(width=scfg.width, height=scfg.height,
                                    num_slots=128, pyramid_levels=3,
                                    per_cell=8, min_distance=12.0, margin=22,
                                    kf_min_trans=0.04),
            backend=BackendConfig(window_size=5, max_landmarks=256,
                                  iters1=8, iters2=4),
            loop=LoopConfig(max_keyframes=64, num_orb_features=128,
                            vocab_words=128, kf_start=10, kf_dist=8,
                            kf_max_dist=64, nkf_closest=2, min_pts=12,
                            min_score=0.03, ratio_ransac=0.3,
                            seq_edge_successors=3),
        )
        cam = camera.make(scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline,
                          width=scfg.width, height=scfg.height)
        n = 16
        half = n // 2
        xs = list(np.linspace(0, 0.6, half)) + \
            list(np.linspace(0.6, 0.02, n - half))
        frames = [scene.render(np.eye(3), -np.asarray([x, 0.0, 0.0]))
                  for x in xs]
        runs = {}
        for dev in (None, jax.devices()[1]):
            sys_ = SlamSystem(cfg, cam, use_loop=True, loop_device=dev)
            for c0 in range(0, n, 8):
                batch = frames[c0:c0 + 8]
                sys_.process_frames(np.stack([b[0] for b in batch]),
                                    np.stack([b[1] for b in batch]))
            sys_.flush_loop()
            runs[dev is None] = sys_
        two, one = runs[False], runs[True]
        assert list(two.loop_closer.bow_db.devices())[0] == jax.devices()[1]
        assert list(one.loop_closer.bow_db.devices())[0] == jax.devices()[0]
        assert two.loop_closer.count == one.loop_closer.count
        np.testing.assert_allclose(np.asarray(two.loop_closer.kf_pc[:n]),
                                   np.asarray(one.loop_closer.kf_pc[:n]),
                                   atol=1e-4)
        assert [(c.kf_i, c.kf_j) for c in two.loop_closer.closures] == \
            [(c.kf_i, c.kf_j) for c in one.loop_closer.closures]

    def test_fused_chunk_matches_stepwise(self):
        """The fused chunk program (frontend + per-keyframe BA + per-frame
        correction feedback in one lax.scan) has the SAME semantics as the
        stepwise no-IMU path: same RNG (frame-id fold), same correction
        timing (applied the frame after each keyframe), same reset ordering
        — so the two trajectories must agree to float tolerance."""
        scfg = SceneConfig()
        scene = PlanarScene(scfg, plane_depth=8.0, seed=11)
        poses = orbit_trajectory(16, step=0.03)
        cfg = SystemConfig(
            frontend=FrontendConfig(width=scfg.width, height=scfg.height,
                                    num_slots=128, pyramid_levels=3, per_cell=8,
                                    min_distance=12.0, margin=22),
            backend=BackendConfig(window_size=5, max_landmarks=256,
                                  iters1=8, iters2=4),
        )
        cam = camera.make(scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline,
                          width=scfg.width, height=scfg.height)
        frames = [scene.render(R, t) for (R, t) in poses]

        sys_a = SlamSystem(cfg, cam)
        for (l, r, _) in frames:
            sys_a.process_frame(l, r)

        sys_b = SlamSystem(cfg, cam)
        chunk = 4
        for c0 in range(0, len(frames), chunk):
            batch = frames[c0:c0 + chunk]
            sys_b.process_frames(np.stack([b[0] for b in batch]),
                                 np.stack([b[1] for b in batch]))

        assert len(sys_a.keyframes) == len(sys_b.keyframes)
        ta = np.asarray([t for (_, _, _, t) in sys_a.trajectory])
        tb = np.asarray([t for (_, _, _, t) in sys_b.trajectory])
        np.testing.assert_allclose(ta, tb, atol=1e-4)

    def test_fused_chunk_failure_recovery_and_reset(self):
        """A blank frame INSIDE a chunk must drive the tracker to FAIL, then
        recover on the next good frame with reset_backend raised — and the
        fused program's in-scan lax.cond reset must actually wipe the BA
        window (the KFMSG_CMD_RESET_LM path, vo_localmap.cpp:89-98) and keep
        tracking to the end of the chunk without NaNs."""
        scfg = SceneConfig()
        scene = PlanarScene(scfg, plane_depth=8.0, seed=7)
        poses = orbit_trajectory(12, step=0.03)
        cfg = SystemConfig(
            frontend=FrontendConfig(width=scfg.width, height=scfg.height,
                                    num_slots=128, pyramid_levels=3, per_cell=8,
                                    min_distance=12.0, margin=22),
            backend=BackendConfig(window_size=5, max_landmarks=256,
                                  iters1=4, iters2=2),
        )
        cam = camera.make(scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline,
                          width=scfg.width, height=scfg.height)
        frames = [scene.render(R, t)[:2] for (R, t) in poses]
        i0 = np.stack([f[0] for f in frames])
        i1 = np.stack([f[1] for f in frames])
        i0[5] = 0.0  # TWO blank frames mid-chunk (two-strike failure entry)
        i1[5] = 0.0
        i0[6] = 0.0
        i1[6] = 0.0

        sys_ = SlamSystem(cfg, cam)
        outs = sys_.process_frames(i0, i1)
        assert int(outs.status[5]) == 1                 # first strike escaped
        assert int(outs.status[6]) == 2                 # second strike → FAIL
        assert int(outs.status[7]) == 1                 # recovered
        assert bool(outs.reset_backend[7])              # reset broadcast
        assert all(int(s) == 1 for s in outs.status[7:])
        # The window was wiped at frame 7: only post-reset keyframes remain.
        n_kf_after = int(np.sum(outs.is_keyframe[7:]))
        assert int(sys_.ba_state.count) == min(n_kf_after,
                                               cfg.backend.window_size)
        C = sys_.trajectory_cam_centers()
        assert np.all(np.isfinite(C))


class TestOverlappedPipeline:
    def test_two_device_pipeline_matches_single_device(self):
        """Frontend on device 0, window BA on device 1 (pipeline.overlap):
        JAX async dispatch overlaps the BA with the next frames' tracking;
        numerics must match the single-device stepwise path exactly (same
        programs, same one-keyframe-late feedback — only the placement
        differs)."""
        import jax

        if len(jax.devices()) < 2:
            pytest.skip("needs 2 devices")
        from flvis_tpu.pipeline.overlap import OverlappedPipeline

        scfg = SceneConfig()
        scene = MultiPlaneScene(scfg, seed=3)
        poses = orbit_trajectory(8, step=0.03)
        cfg = SystemConfig(
            frontend=FrontendConfig(width=scfg.width, height=scfg.height,
                                    num_slots=128, pyramid_levels=3,
                                    per_cell=8, min_distance=12.0, margin=22),
            backend=BackendConfig(window_size=5, max_landmarks=256,
                                  iters1=4, iters2=2))
        cam = camera.make(scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline,
                          width=scfg.width, height=scfg.height)
        frames = [scene.render(R, t)[:2] for (R, t) in poses]

        pipe = OverlappedPipeline(cfg, cam)
        ref = SlamSystem(cfg, cam)
        for (il, ir) in frames:
            pipe.process_frame(il, ir)
            ref.process_frame(il, ir)
        # Backend state really lives on the second device.
        assert pipe.ba_dev != pipe.fe_dev
        assert list(pipe.ba_state.kf_q.devices())[0] == pipe.ba_dev
        assert list(pipe.fe_state.T_c_w.q.devices())[0] == pipe.fe_dev
        t_pipe = np.asarray([t for (_, _, t) in pipe.trajectory])
        t_ref = np.asarray([t for (_, _, q, t) in ref.trajectory])
        np.testing.assert_allclose(t_pipe, t_ref, atol=1e-6)
        # De-synced contract: exactly ONE host device-fetch per frame (all
        # frame-loop transfers funnel through _fetch; the keyframe decision
        # and BA dispatch never touch the host).
        assert pipe.fetch_count == len(frames)
        costs = pipe.ba_costs()      # fetched off the frame loop
        assert len(costs) == len(ref.ba_costs)
        assert all(np.isfinite(c) for c in costs)


class TestVioChunk:
    def test_fused_vio_chunk_matches_stepwise(self, tmp_path):
        """EuRoC-mode chunked replay: the fused VIO chunk program (IMU
        propagation + feedforward prior + RP compensation + window BA +
        vision feedback inside one lax.scan) must track a synthetic
        EuRoC-format sequence as well as the stepwise IMU path, and both
        must beat the ATE bound."""
        from flvis_tpu.io.euroc import EurocDataset
        from flvis_tpu.io.synthetic import export_euroc_sequence

        export_euroc_sequence(str(tmp_path), num_frames=16, seed=6)
        ds = EurocDataset(str(tmp_path))
        frames = list(ds.frames())
        cam = ds.camera
        cfg = SystemConfig(
            frontend=FrontendConfig(width=cam.width, height=cam.height,
                                    num_slots=128, pyramid_levels=3, per_cell=8,
                                    min_distance=12.0, margin=22),
            backend=BackendConfig(window_size=5, max_landmarks=256,
                                  iters1=6, iters2=3),
        )

        def ate(sys_):
            C = sys_.trajectory_cam_centers()
            ts = np.asarray([t for (_, t, _, _) in sys_.trajectory])
            from flvis_tpu.utils import evaluation
            ia, ib = evaluation.associate(ts, ds.gt_t)
            rmse, _ = evaluation.ate_rmse(C[ia], ds.gt_pos[ib])
            return rmse

        sys_a = SlamSystem(cfg, cam, T_i_c=ds.T_i_c, use_imu=True)
        for fr in frames:
            if len(fr.imu_t):
                sys_a.feed_imu(fr.imu_acc, fr.imu_gyro, fr.imu_t)
            sys_a.process_frame(fr.img0, fr.img1, t_img=fr.t)

        sys_b = SlamSystem(cfg, cam, T_i_c=ds.T_i_c, use_imu=True)
        chunk = 8
        for c0 in range(0, len(frames), chunk):
            b = frames[c0:c0 + chunk]
            sys_b.process_frames_vio(
                np.stack([f.img0 for f in b]), np.stack([f.img1 for f in b]),
                ts=np.asarray([f.t for f in b]),
                imu_acc=[f.imu_acc for f in b],
                imu_gyro=[f.imu_gyro for f in b],
                imu_t=[f.imu_t for f in b])

        ate_a, ate_b = ate(sys_a), ate(sys_b)
        assert ate_a < 0.02, f"stepwise VIO ATE {ate_a:.4f} m"
        assert ate_b < 0.02, f"fused VIO chunk ATE {ate_b:.4f} m"
        # Same semantics → closely matching trajectories.
        ta = np.asarray([t for (_, _, _, t) in sys_a.trajectory])
        tb = np.asarray([t for (_, _, _, t) in sys_b.trajectory])
        np.testing.assert_allclose(ta, tb, atol=2e-3)


class TestVioLoopHeadline:
    def test_chunked_vio_loop_closes_and_tracks(self):
        """The reference's TRUE default launch runs ALL THREE stages at once
        — tracking + window BA + loop closing, with IMU
        (/root/reference/flvis.xml:1-23, launch/flvis_euroc_mav.launch:29
        loads all three nodelets; EuRoC configs set imu_topic).  This drives
        the same composition here: SlamSystem(use_imu=True, use_loop=True)
        chunked over an out-and-back sequence with trajectory-consistent
        IMU, asserting the loop node detects the revisit AND the trajectory
        holds the ATE bound."""
        from flvis_tpu.config import LoopConfig
        from flvis_tpu.io.synthetic import imu_from_trajectory

        scfg = SceneConfig(width=256, height=192, fx=200.0, fy=200.0,
                           cx=128.0, cy=96.0, baseline=0.12)
        scene = PlanarScene(scfg, plane_depth=8.0, seed=11)
        cfg = SystemConfig(
            frontend=FrontendConfig(width=scfg.width, height=scfg.height,
                                    num_slots=128, pyramid_levels=3,
                                    per_cell=8, min_distance=12.0, margin=22,
                                    kf_min_trans=0.04),
            backend=BackendConfig(window_size=5, max_landmarks=256,
                                  iters1=8, iters2=4),
            loop=LoopConfig(max_keyframes=64, num_orb_features=128,
                            vocab_words=128, kf_start=10, kf_dist=8,
                            kf_max_dist=64, nkf_closest=2, min_pts=12,
                            min_score=0.03, ratio_ransac=0.3,
                            seq_edge_successors=3),
        )
        cam = camera.make(scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline,
                          width=scfg.width, height=scfg.height)
        # Out-and-back pan: the tail frames revisit the head viewpoints.
        n = 24
        half = n // 2
        xs = list(np.linspace(0, 0.9, half)) + \
            list(np.linspace(0.9, 0.02, n - half))
        poses = [(np.eye(3), -np.asarray([x, 0.0, 0.0])) for x in xs]
        frames = [scene.render(R, t) for (R, t) in poses]
        fps = 20.0
        t_imu, gyro, acc, frame_t = imu_from_trajectory(poses, fps=fps)
        accs, gyros, imuts = [], [], []
        prev = -np.inf
        for ft in frame_t:
            m = (t_imu > prev) & (t_imu <= ft)
            accs.append(acc[m]); gyros.append(gyro[m]); imuts.append(t_imu[m])
            prev = ft

        sys_ = SlamSystem(cfg, cam, use_imu=True, use_loop=True)
        chunk = 8
        for c0 in range(0, n, chunk):
            sl = slice(c0, c0 + chunk)
            sys_.process_frames_vio(
                np.stack([f[0] for f in frames[sl]]),
                np.stack([f[1] for f in frames[sl]]),
                ts=frame_t[sl], imu_acc=accs[sl], imu_gyro=gyros[sl],
                imu_t=imuts[sl])
            assert sys_.loop_closer.count == len(sys_.keyframes)
        sys_.flush_loop()
        closures = sys_.loop_closer.closures
        assert len(closures) >= 1, "revisit not detected in VIO+loop mode"
        assert closures[0].kf_j - closures[0].kf_i >= 8
        C_est = sys_.trajectory_cam_centers()
        C_gt = np.asarray([-R.T @ t for (R, t) in poses])
        ate = np.sqrt(np.mean(np.sum((C_est - C_gt) ** 2, axis=-1)))
        path = 2 * 0.9
        assert ate < 0.02 * path + 0.01, f"ATE {ate:.4f} m over {path:.2f} m"


class TestPipelinedChunks:
    """SlamSystem(pipelined=True): double-buffered chunk replay.

    Chunk N+1's fused program dispatches before chunk N's packed fetch
    resolves, and the loop node's verify/PGO lag one further chunk — the
    single-chip equivalent of the reference's concurrently running nodelets
    (vo_tracking.cpp:396-482, vo_loopclosing.cpp:181-518).  Results must be
    IDENTICAL to the synchronous mode modulo the documented one-chunk
    return lag."""

    def _cfg_scene(self):
        from flvis_tpu.config import LoopConfig

        scfg = SceneConfig(width=256, height=192, fx=200.0, fy=200.0,
                           cx=128.0, cy=96.0, baseline=0.12)
        scene = PlanarScene(scfg, plane_depth=8.0, seed=11)
        cfg = SystemConfig(
            frontend=FrontendConfig(width=scfg.width, height=scfg.height,
                                    num_slots=128, pyramid_levels=3,
                                    per_cell=8, min_distance=12.0, margin=22,
                                    kf_min_trans=0.04),
            backend=BackendConfig(window_size=5, max_landmarks=256,
                                  iters1=8, iters2=4),
            loop=LoopConfig(max_keyframes=64, num_orb_features=128,
                            vocab_words=128, kf_start=10, kf_dist=8,
                            kf_max_dist=64, nkf_closest=2, min_pts=12,
                            min_score=0.03, ratio_ransac=0.3,
                            seq_edge_successors=3),
        )
        cam = camera.make(scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline,
                          width=scfg.width, height=scfg.height)
        return scfg, scene, cfg, cam

    def test_pipelined_matches_sync_with_loop(self):
        scfg, scene, cfg, cam = self._cfg_scene()
        n = 24
        half = n // 2
        xs = list(np.linspace(0, 0.9, half)) + \
            list(np.linspace(0.9, 0.02, n - half))
        frames = [scene.render(np.eye(3), -np.asarray([x, 0.0, 0.0]))
                  for x in xs]
        runs = {}
        for pipelined in (False, True):
            sys_ = SlamSystem(cfg, cam, use_loop=True, pipelined=pipelined)
            rets = []
            for c0 in range(0, n, 8):
                batch = frames[c0:c0 + 8]
                rets.append(sys_.process_frames(
                    np.stack([b[0] for b in batch]),
                    np.stack([b[1] for b in batch])))
            last = sys_.flush()
            if pipelined:
                # One-chunk return lag: first call yields None, flush()
                # yields the final chunk.
                assert rets[0] is None
                assert all(r is not None for r in rets[1:])
                assert last is not None
                np.testing.assert_array_equal(last.status,
                                              runs[False][2][-1].status)
            else:
                sys_.flush_loop()
            runs[pipelined] = (sys_, rets, [r for r in rets if r is not None]
                               + ([last] if last is not None else []))
        sync_sys, pipe_sys = runs[False][0], runs[True][0]
        # Tracking path is loop-independent: trajectories bit-identical.
        t_sync = np.asarray([t for (_, _, _, t) in sync_sys.trajectory])
        t_pipe = np.asarray([t for (_, _, _, t) in pipe_sys.trajectory])
        np.testing.assert_array_equal(t_sync, t_pipe)
        assert len(pipe_sys.trajectory) == n
        # Same keyframe stream and identical accepted loop closures.
        assert pipe_sys.loop_closer.count == sync_sys.loop_closer.count
        assert [(c.kf_i, c.kf_j) for c in pipe_sys.loop_closer.closures] == \
            [(c.kf_i, c.kf_j) for c in sync_sys.loop_closer.closures]
        assert len(pipe_sys.loop_closer.closures) >= 1
        # Drift transforms agree once both pipelines drained.
        np.testing.assert_allclose(
            np.asarray(pipe_sys.loop_closer.T_map_odom.t),
            np.asarray(sync_sys.loop_closer.T_map_odom.t), atol=1e-4)

    def test_pipelined_vio_matches_sync(self):
        from flvis_tpu.io.synthetic import imu_from_trajectory

        scfg, scene, cfg, cam = self._cfg_scene()
        n = 16
        xs = np.linspace(0, 0.6, n)
        poses = [(np.eye(3), -np.asarray([x, 0.0, 0.0])) for x in xs]
        frames = [scene.render(R, t) for (R, t) in poses]
        t_imu, gyro, acc, frame_t = imu_from_trajectory(poses, fps=20.0)
        accs, gyros, imuts = [], [], []
        prev = -np.inf
        for ft in frame_t:
            m = (t_imu > prev) & (t_imu <= ft)
            accs.append(acc[m]); gyros.append(gyro[m]); imuts.append(t_imu[m])
            prev = ft
        trajs = {}
        for pipelined in (False, True):
            sys_ = SlamSystem(cfg, cam, use_imu=True, pipelined=pipelined)
            for c0 in range(0, n, 8):
                sl = slice(c0, c0 + 8)
                sys_.process_frames_vio(
                    np.stack([f[0] for f in frames[sl]]),
                    np.stack([f[1] for f in frames[sl]]),
                    ts=frame_t[sl], imu_acc=accs[sl], imu_gyro=gyros[sl],
                    imu_t=imuts[sl])
            sys_.flush()
            trajs[pipelined] = np.asarray(
                [t for (_, _, _, t) in sys_.trajectory])
        np.testing.assert_array_equal(trajs[False], trajs[True])
        assert trajs[True].shape[0] == n


class TestImuPacking:
    def test_first_frame_history_predrained_and_overflow_raises(self):
        """The first frame of a chunk may carry the whole pre-camera IMU
        history (EuRoC's imu0 starts before cam0): process_frames_vio must
        pre-drain it through the stepwise feed instead of dropping samples;
        an oversized MID-chunk window is a configuration error and raises."""
        from flvis_tpu.pipeline.runner import pack_imu_frames

        acc = [np.zeros((40, 3)), np.zeros((10, 3))]
        gyro = [np.zeros((40, 3)), np.zeros((10, 3))]
        ts = [np.arange(40) * 0.005, 0.2 + np.arange(10) * 0.005]
        with pytest.raises(ValueError):
            pack_imu_frames(acc, gyro, ts, pad=16)

        scfg = SceneConfig()
        scene = PlanarScene(scfg, plane_depth=8.0, seed=4)
        poses = orbit_trajectory(2, step=0.03)
        cfg = SystemConfig(
            frontend=FrontendConfig(width=scfg.width, height=scfg.height,
                                    num_slots=64, pyramid_levels=2, per_cell=4,
                                    min_distance=12.0, margin=22),
            backend=BackendConfig(window_size=3, max_landmarks=128,
                                  iters1=2, iters2=1),
        )
        cam = camera.make(scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline,
                          width=scfg.width, height=scfg.height)
        sys_ = SlamSystem(cfg, cam, use_imu=True)
        frames = [scene.render(R, t)[:2] for (R, t) in poses]
        # First frame carries 40 samples of static pre-camera history.
        g = np.zeros((40, 3), np.float32)
        a = np.tile(np.asarray([0, 0, 9.81], np.float32), (40, 1))
        t_hist = (np.arange(40) * 0.005).astype(np.float32)
        sys_.process_frames_vio(
            np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames]),
            ts=np.asarray([0.2, 0.25]),
            imu_acc=[a, a[:10]], imu_gyro=[g, g[:10]],
            imu_t=[t_hist, (0.2 + np.arange(10) * 0.005).astype(np.float32)])
        # All 50 samples reached the VIO ring (none dropped).
        assert int(sys_.vio_state.count) == 50


class TestMultiDepthScene:
    def test_ate_on_multi_plane_structure(self):
        """Golden run on a scene with real depth VARIATION (occluding slabs
        at 4/7/12 m): exercises disparity spread, occlusion boundaries and
        the non-degenerate epipolar case the single plane cannot.  Full
        system (frontend + window BA + feedback), chunked replay."""
        scfg = SceneConfig()
        scene = MultiPlaneScene(scfg, depths=(4.0, 7.0, 12.0), seed=3)
        poses = orbit_trajectory(24, step=0.03)
        cfg = SystemConfig(
            frontend=FrontendConfig(width=scfg.width, height=scfg.height,
                                    num_slots=128, pyramid_levels=3, per_cell=8,
                                    min_distance=12.0, margin=22),
            backend=BackendConfig(window_size=5, max_landmarks=256,
                                  iters1=8, iters2=4),
        )
        cam = camera.make(scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline,
                          width=scfg.width, height=scfg.height)
        sys_ = SlamSystem(cfg, cam)
        frames = [scene.render(R, t) for (R, t) in poses]
        chunk = 8
        for c0 in range(0, len(frames), chunk):
            batch = frames[c0:c0 + chunk]
            sys_.process_frames(np.stack([b[0] for b in batch]),
                                np.stack([b[1] for b in batch]))
        C_est = sys_.trajectory_cam_centers()
        C_gt = np.asarray([-R.T @ t for (R, t) in poses])
        ate = np.sqrt(np.mean(np.sum((C_est - C_gt) ** 2, axis=-1)))
        path = 0.03 * len(poses)
        assert ate < 0.02 * path + 0.01, f"ATE {ate:.4f} m over {path:.2f} m"

    def test_depth_render_consistency(self):
        """Rendered stereo disparity must match the rendered depth map:
        d = fx·b/z ⇒ sampling the right image at (u−d, v) reproduces the
        left image away from occlusion boundaries."""
        scfg = SceneConfig()
        scene = MultiPlaneScene(scfg, depths=(4.0, 9.0), seed=1)
        R0 = np.eye(3, dtype=np.float32)
        t0 = np.zeros(3, np.float32)
        l, r, z = scene.render(R0, t0)
        ys, xs = np.mgrid[40:scfg.height - 40:24, 40:scfg.width - 40:24]
        ok = err = 0
        for y, x in zip(ys.ravel(), xs.ravel()):
            d = scfg.fx * scfg.baseline / z[y, x]
            xr = x - d
            if xr < 1 or xr > scfg.width - 2:
                continue
            x0 = int(xr); f = xr - x0
            val = r[y, x0] * (1 - f) + r[y, x0 + 1] * f
            ok += 1
            err += abs(float(val) - float(l[y, x]))
        assert ok > 50
        # Mean photometric error small (bilinear resample + occlusions).
        assert err / ok < 12.0, err / ok
