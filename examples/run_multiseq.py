#!/usr/bin/env python
"""Run MANY independent SLAM sequences data-parallel on one mesh.

The production "all EuRoC runs at once" surface: S synthetic stereo
sequences (distinct scenes + trajectories, exact ground truth) batched
through the full pipeline — tracking + sliding-window BA + feedback, with
optional per-sequence IMU fusion and loop closing — as ONE device program
per chunk (parallel.multiseq_loop.MultiSeqSlam).  Reports per-sequence ATE
and aggregate frames/s.  The reference runs one ROS process per rosbag
(SURVEY.md §2.3); this is the equivalent of launching them all at once.

Usage:
  python examples/run_multiseq.py --cpu --seqs 4 --frames 16
  python examples/run_multiseq.py --cpu --seqs 2 --frames 32 --loop
  python examples/run_multiseq.py --cpu --seqs 4 --frames 16 --imu --pipelined
  python examples/run_multiseq.py --cpu --seqs 8 --mesh   # seq-sharded mesh
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seqs", type=int, default=4)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--cpu", action="store_true",
                    help="force the local CPU backend")
    ap.add_argument("--imu", action="store_true",
                    help="full VIO loop per sequence")
    ap.add_argument("--loop", action="store_true",
                    help="loop closing per sequence (out-and-back paths)")
    ap.add_argument("--pipelined", action="store_true",
                    help="double-buffered chunk replay")
    ap.add_argument("--mesh", action="store_true",
                    help="shard the seq axis over all visible devices "
                         "(zero-collective shard_map chunk program)")
    ap.add_argument("--ba-every", type=int, default=1)
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from flvis_tpu.config import (BackendConfig, FrontendConfig, LoopConfig,
                                  SystemConfig)
    from flvis_tpu.geometry import camera
    from flvis_tpu.io.synthetic import (PlanarScene, SceneConfig,
                                        imu_from_trajectory)
    from flvis_tpu.parallel import multiseq
    from flvis_tpu.parallel.multiseq_loop import MultiSeqSlam
    from flvis_tpu.pipeline.runner import pack_imu_frames

    S, n = args.seqs, args.frames
    n -= n % args.chunk
    if n == 0:
        raise SystemExit("--frames must be >= --chunk")
    # Stereo geometry with OBSERVABLE depth at this resolution
    # (disparity = fx*b/z = 200*0.2/4 = 10 px): with 0.12 m baseline and an
    # 8 m plane the loop node's keypoint-depth noise dominated short-path
    # ATE.  The PASS bound adds a 1.5 cm absolute floor: short demo paths
    # sit at the tracker's absolute noise floor, not its relative one.
    scfg = SceneConfig(width=256, height=192, fx=200.0, fy=200.0,
                       cx=128.0, cy=96.0, baseline=0.2)
    cam = camera.make(scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline,
                      width=scfg.width, height=scfg.height)
    cfg = SystemConfig(
        frontend=FrontendConfig(width=scfg.width, height=scfg.height,
                                num_slots=128, pyramid_levels=3, per_cell=8,
                                min_distance=12.0, margin=22,
                                kf_min_trans=0.04),
        backend=BackendConfig(window_size=5, max_landmarks=256,
                              iters1=8, iters2=4),
        loop=LoopConfig(max_keyframes=64, num_orb_features=128,
                        vocab_words=128, kf_start=10, kf_dist=8,
                        kf_max_dist=64, nkf_closest=2, min_pts=12,
                        min_score=0.03, ratio_ransac=0.3,
                        seq_edge_successors=3),
    )

    # Per-sequence scenes and trajectories (out-and-back when loop closing
    # is on so the tails genuinely revisit; straight pans otherwise).
    rng = np.random.default_rng(0)
    seq_frames, seq_poses = [], []
    for s in range(S):
        scene = PlanarScene(scfg, plane_depth=4.0, seed=10 + s)
        step = 0.03 + 0.005 * rng.random()
        if args.loop:
            half = n // 2
            xs = list(np.linspace(0, step * half, half)) + \
                list(np.linspace(step * half, 0.02, n - half))
        else:
            xs = [step * i for i in range(n)]
        poses = [(np.eye(3), -np.asarray([x, 0.0, 0.0])) for x in xs]
        seq_poses.append(poses)
        seq_frames.append([scene.render(R, t) for (R, t) in poses])

    mesh = multiseq.make_mesh() if args.mesh else None
    ms = MultiSeqSlam(cfg, cam, num_seqs=S, use_imu=args.imu,
                      use_loop=args.loop, mesh=mesh,
                      ba_every=args.ba_every, pipelined=args.pipelined)

    imu = None
    if args.imu:
        imu = []
        for s in range(S):
            t_imu, gyro, acc, frame_t = imu_from_trajectory(
                seq_poses[s], fps=20.0)
            accs, gyros, imuts = [], [], []
            prev = -np.inf
            for ft in frame_t:
                m = (t_imu > prev) & (t_imu <= ft)
                accs.append(acc[m]); gyros.append(gyro[m])
                imuts.append(t_imu[m]); prev = ft
            imu.append((frame_t, accs, gyros, imuts))

    t0 = time.perf_counter()
    compile_t = None
    for c0 in range(0, n, args.chunk):
        sl = slice(c0, c0 + args.chunk)
        i0 = np.stack([np.stack([f[0] for f in fr[sl]])
                       for fr in seq_frames])
        i1 = np.stack([np.stack([f[1] for f in fr[sl]])
                       for fr in seq_frames])
        if args.imu:
            packs = [pack_imu_frames(imu[s][1][sl], imu[s][2][sl],
                                     imu[s][3][sl], 16) for s in range(S)]
            ms.process_chunk_vio(
                i0, i1,
                np.stack([np.asarray(imu[s][0][sl], np.float32)
                          for s in range(S)]),
                np.stack([p[0] for p in packs]),
                np.stack([p[1] for p in packs]),
                np.stack([p[2] for p in packs]),
                np.stack([p[3] for p in packs]))
        else:
            ms.process_chunk(i0, i1)
        if compile_t is None:
            compile_t = time.perf_counter() - t0
            t0 = time.perf_counter()
            n_timed = n - args.chunk
    ms.flush()
    elapsed = time.perf_counter() - t0
    fps = S * n_timed / elapsed if n_timed else float("nan")

    print(f"\n{S} sequences x {n} frames  (compile+first chunk "
          f"{compile_t:.1f} s; steady {fps:.1f} frames/s aggregate)")
    fail = False
    for s in range(S):
        C = ms.trajectory_cam_centers(s, loop_corrected=args.loop)
        C_gt = np.asarray([-R.T @ t for (R, t) in seq_poses[s]])
        ate = np.sqrt(np.mean(np.sum((C - C_gt) ** 2, axis=-1)))
        path = float(np.abs(np.diff(C_gt[:, 0])).sum())
        lc = ms.loopers[s]
        loops = len(lc.closures) if lc is not None else 0
        status = "ok" if ate < 0.02 * path + 0.015 else "HIGH"
        fail |= status != "ok"
        print(f"  seq {s}: ATE {100*ate:6.2f} cm over {path:.2f} m "
              f"({status}){f'  loops={loops}' if args.loop else ''}")
    print("RESULT:", "FAIL" if fail else "PASS")
    return 1 if fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
