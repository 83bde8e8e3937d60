"""Multi-sequence DP WITH the per-sequence loop stage (MultiSeqSlam).

Own module (not test_parallel.py): these tests compile the single-sequence
fused VIO chunk AND the batched DP chunk AND the loop-node programs — on
top of test_parallel's already-heavy program set they pushed XLA:CPU past
the 2-CPU box's memory edge and segfaulted the compiler mid-suite
(conftest clears compile caches per MODULE, so a fresh module bounds the
live-executable set)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flvis_tpu.backend import window_ba
from flvis_tpu.config import BackendConfig, FrontendConfig
from flvis_tpu.geometry import camera, se3
from flvis_tpu.parallel import multiseq


class TestMultiSeqLoop:
    def test_dp_loop_matches_single_sequence_loop(self):
        """Multi-sequence DP WITH the loop stage (MultiSeqSlam): every
        sequence runs its own loop node over the batched chunk outputs, and
        an out-and-back revisit closes the same loops the single-sequence
        SlamSystem path accepts (the reference loads the loop nodelet in
        EVERY launch, flvis.xml:14-18 — a DP configuration without it would
        benchmark a system the reference never ships)."""
        from flvis_tpu.config import LoopConfig, SystemConfig
        from flvis_tpu.io.synthetic import PlanarScene, SceneConfig
        from flvis_tpu.parallel.multiseq_loop import MultiSeqSlam
        from flvis_tpu.pipeline.runner import SlamSystem

        scfg = SceneConfig(width=256, height=192, fx=200.0, fy=200.0,
                           cx=128.0, cy=96.0, baseline=0.12)
        scene = PlanarScene(scfg, plane_depth=8.0, seed=11)
        cfg = SystemConfig(
            frontend=FrontendConfig(width=scfg.width, height=scfg.height,
                                    num_slots=128, pyramid_levels=3,
                                    per_cell=8, min_distance=12.0, margin=22,
                                    kf_min_trans=0.04, pnp_fallback=False),
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
        n = 24
        half = n // 2
        xs = list(np.linspace(0, 0.9, half)) + \
            list(np.linspace(0.9, 0.02, n - half))
        frames = [scene.render(np.eye(3), -np.asarray([x, 0.0, 0.0]))
                  for x in xs]
        i0 = np.stack([f[0] for f in frames])
        i1 = np.stack([f[1] for f in frames])

        # Single-sequence reference run (synchronous loop path).
        single = SlamSystem(cfg, cam, use_loop=True)
        for c0 in range(0, n, 8):
            single.process_frames(i0[c0:c0 + 8], i1[c0:c0 + 8])
        single.flush_loop()
        assert len(single.loop_closer.closures) >= 1

        # Two identical sequences through the DP + loop path.
        S = 2
        ms = MultiSeqSlam(cfg, cam, num_seqs=S, use_loop=True)
        for c0 in range(0, n, 8):
            b0 = np.broadcast_to(i0[c0:c0 + 8], (S,) + i0[c0:c0 + 8].shape)
            b1 = np.broadcast_to(i1[c0:c0 + 8], (S,) + i1[c0:c0 + 8].shape)
            ms.process_chunk(b0, b1)
        ms.flush()

        # Pipelined DP+loop: chunk N+1 dispatches before chunk N's finish;
        # loop stages lag one extra chunk but the dataflow is identical.
        msp = MultiSeqSlam(cfg, cam, num_seqs=S, use_loop=True,
                           pipelined=True)
        rets = []
        for c0 in range(0, n, 8):
            b0 = np.broadcast_to(i0[c0:c0 + 8], (S,) + i0[c0:c0 + 8].shape)
            b1 = np.broadcast_to(i1[c0:c0 + 8], (S,) + i1[c0:c0 + 8].shape)
            rets.append(msp.process_chunk(b0, b1))
        assert rets[0] is None          # one-chunk return lag
        last = msp.flush()
        assert last is not None
        for s in range(S):
            assert msp.loopers[s].count == ms.loopers[s].count
            assert [(c.kf_i, c.kf_j) for c in msp.loopers[s].closures] == \
                [(c.kf_i, c.kf_j) for c in ms.loopers[s].closures]
            t_p = np.asarray([t for (_, _, _, t) in msp.trajectories[s]])
            t_s = np.asarray([t for (_, _, _, t) in ms.trajectories[s]])
            np.testing.assert_array_equal(t_p, t_s)

        for s in range(S):
            lc = ms.loopers[s]
            assert lc.count == single.loop_closer.count
            assert [(c.kf_i, c.kf_j) for c in lc.closures] == \
                [(c.kf_i, c.kf_j) for c in single.loop_closer.closures]
            # Same trajectory modulo vmap reduction-order jitter.
            t_ms = np.asarray([t for (_, _, _, t) in ms.trajectories[s]])
            t_1 = np.asarray([t for (_, _, _, t) in single.trajectory])
            np.testing.assert_allclose(t_ms, t_1, atol=1e-3)
            # Drift estimate agrees once both drained.
            np.testing.assert_allclose(
                np.asarray(lc.T_map_odom.t),
                np.asarray(single.loop_closer.T_map_odom.t), atol=1e-3)

    def test_dp_vio_loop_matches_single_sequence(self):
        """VIO variant: the full three-nodelet composition (IMU + tracking +
        BA + loop) data-parallel, vs the single-sequence VIO+loop path."""
        from flvis_tpu.config import LoopConfig, SystemConfig, VioConfig
        from flvis_tpu.io.synthetic import (PlanarScene, SceneConfig,
                                            imu_from_trajectory)
        from flvis_tpu.parallel.multiseq_loop import MultiSeqSlam
        from flvis_tpu.pipeline.runner import SlamSystem, pack_imu_frames

        scfg = SceneConfig(width=256, height=192, fx=200.0, fy=200.0,
                           cx=128.0, cy=96.0, baseline=0.12)
        scene = PlanarScene(scfg, plane_depth=8.0, seed=11)
        cfg = SystemConfig(
            frontend=FrontendConfig(width=scfg.width, height=scfg.height,
                                    num_slots=128, pyramid_levels=3,
                                    per_cell=8, min_distance=12.0, margin=22,
                                    kf_min_trans=0.04, pnp_fallback=False),
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
        n = 24
        half = n // 2
        xs = list(np.linspace(0, 0.9, half)) + \
            list(np.linspace(0.9, 0.02, n - half))
        poses = [(np.eye(3), -np.asarray([x, 0.0, 0.0])) for x in xs]
        frames = [scene.render(R, t) for (R, t) in poses]
        t_imu, gyro, acc, frame_t = imu_from_trajectory(poses, fps=20.0)
        accs, gyros, imuts = [], [], []
        prev = -np.inf
        for ft in frame_t:
            m = (t_imu > prev) & (t_imu <= ft)
            accs.append(acc[m]); gyros.append(gyro[m]); imuts.append(t_imu[m])
            prev = ft
        i0 = np.stack([f[0] for f in frames])
        i1 = np.stack([f[1] for f in frames])

        single = SlamSystem(cfg, cam, use_imu=True, use_loop=True)
        for c0 in range(0, n, 8):
            sl = slice(c0, c0 + 8)
            single.process_frames_vio(i0[sl], i1[sl], ts=frame_t[sl],
                                      imu_acc=accs[sl], imu_gyro=gyros[sl],
                                      imu_t=imuts[sl])
        single.flush_loop()
        assert len(single.loop_closer.closures) >= 1

        S = 2
        ms = MultiSeqSlam(cfg, cam, num_seqs=S, use_imu=True, use_loop=True)
        for c0 in range(0, n, 8):
            sl = slice(c0, c0 + 8)
            a_p, g_p, t_p, v_p = pack_imu_frames(accs[sl], gyros[sl],
                                                 imuts[sl], 16)
            bc = lambda a: np.broadcast_to(np.asarray(a),
                                           (S,) + np.shape(a))
            ms.process_chunk_vio(
                bc(i0[sl]), bc(i1[sl]),
                bc(np.asarray(frame_t[sl], np.float32)),
                bc(a_p), bc(g_p), bc(t_p), bc(v_p))
        ms.flush()
        for s in range(S):
            lc = ms.loopers[s]
            assert lc.count == single.loop_closer.count
            assert [(c.kf_i, c.kf_j) for c in lc.closures] == \
                [(c.kf_i, c.kf_j) for c in single.loop_closer.closures]
            t_ms = np.asarray([t for (_, _, _, t) in ms.trajectories[s]])
            t_1 = np.asarray([t for (_, _, _, t) in single.trajectory])
            np.testing.assert_allclose(t_ms, t_1, atol=1e-3)
