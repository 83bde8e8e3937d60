#!/usr/bin/env python
"""VIO on a fast closed path: where its trajectory error comes from.

The path is one period of `periodic_trajectory(64)` in 64 frames at 20 Hz,
with lateral accelerations up to 1.2 m/s^2 (four times the per-frame motion
of `periodic_trajectory(256)`).  Four sequences fly it 0.4 m apart along the
textured plane.  Frames are 752x480 (`--half`: 376x240).

  python examples/fast_motion_vio.py paths [--cpu] [--half]
      Every sequence through SlamSystem(use_imu=True) alone, then through
      MultiSeqSlam batched over all four and over one sequence with the
      PnP rescue off (as the batched programs run), then over all four
      with it on.  Prints ATE, the fewest motion-BA inliers, starved
      frames, and the worst-frame distance to the single-sequence run.
  python examples/fast_motion_vio.py ablate [--cpu] [--half]
      Sequence 0 through SlamSystem with vision only, with VIO as
      configured, and with VIO with one piece changed: an accelerometer
      that reads gravity only, Madgwick beta 0, RP blend 0, bias gains 0.
      Then vision and VIO on the same path at a quarter of the speed.
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

T, S, FPS = 64, 4, 20.0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("paths", "ablate"))
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    ap.add_argument("--half", action="store_true", help="376x240 frames")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from flvis_tpu.config import SystemConfig, VioConfig, bench_frontend_config
    from flvis_tpu.geometry import camera
    from flvis_tpu.io.synthetic import (PlanarScene, SceneConfig,
                                        imu_from_trajectory,
                                        periodic_trajectory)
    from flvis_tpu.parallel import multiseq
    from flvis_tpu.parallel.multiseq_loop import MultiSeqSlam
    from flvis_tpu.pipeline.runner import SlamSystem, pack_imu_frames
    from flvis_tpu.utils import compile_cache, evaluation

    compile_cache.enable(cpu=jax.default_backend() == "cpu")
    print(f"devices: {jax.devices()}", flush=True)
    W, H, F = (376, 240, 229.0) if args.half else (752, 480, 458.0)
    fcfg = bench_frontend_config()
    if args.half:
        fcfg = dataclasses.replace(fcfg, width=W, height=H, min_distance=10.0,
                                   margin=12, lk_radius=6)
    cfg = SystemConfig(frontend=fcfg)
    scfg = SceneConfig(width=W, height=H, fx=F, fy=F, cx=W / 2, cy=H / 2,
                       baseline=0.11)
    cam = camera.make(F, F, W / 2, H / 2, 0.11, width=W, height=H)
    u8 = lambda a: np.clip(np.round(np.asarray(a)), 0, 255).astype(np.uint8)

    def sequence(period, s):
        poses = [(R, t - R @ np.array([0.4 * s, 0.0, 0.0]))
                 for R, t in periodic_trajectory(period)[:T]]
        scene = PlanarScene(scfg, plane_depth=8.0, seed=0)
        frames = [scene.render(R, t) for R, t in poses]
        gt = np.asarray([-R.T @ t for R, t in poses])
        return (np.stack([u8(f[0]) for f in frames]),
                np.stack([u8(f[1]) for f in frames]), poses, gt)

    def imu(poses, gravity_only=False):
        t_imu, gyro, acc, frame_t = imu_from_trajectory(poses, fps=FPS)
        if gravity_only:
            fidx = np.minimum(((t_imu - t_imu[0]) * FPS).astype(int), T - 1)
            acc = np.stack([poses[i][0] @ np.array([0.0, 0.0, 9.81])
                            for i in fidx]).astype(np.float32)
        accs, gyros, ts, prev = [], [], [], -np.inf
        for ft in frame_t:
            sel = (t_imu > prev) & (t_imu <= ft)
            accs.append(acc[sel]); gyros.append(gyro[sel]); ts.append(t_imu[sel])
            prev = ft
        return frame_t, accs, gyros, ts

    def ate(c, gt):
        path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
        return evaluation.ate_rmse(c, gt)[0], path

    def single(i0, i1, poses, c=cfg, use_imu=True, gravity_only=False):
        slam = SlamSystem(c, cam, use_imu=use_imu, use_loop=False)
        if use_imu:
            out = slam.process_frames_vio(i0, i1, *imu(poses, gravity_only))
        else:
            out = slam.process_frames(i0, i1)
        return (slam.trajectory_cam_centers(), np.asarray(out.num_inliers),
                np.asarray(out.status))

    def report(name, c, gt, inl, status, ref=None):
        e, path = ate(c, gt)
        line = (f"{name}: ATE {e:.4f} m over {path:.2f} m, tracking "
                f"{int(np.sum(status == 1))}/{len(status)}, fewest inliers "
                f"{int(inl.min())}, starved frames "
                f"{np.nonzero(inl < cfg.frontend.min_inliers)[0].tolist()}")
        if ref is not None:
            line += f", worst frame vs alone {np.linalg.norm(c - ref, axis=-1).max():.2e} m"
        print(line, flush=True)

    if args.mode == "ablate":
        i0, i1, poses, gt = sequence(T, 0)
        c, inl, st = single(i0, i1, poses, use_imu=False)
        report("vision only", c, gt, inl, st)
        variants = {
            "VIO as configured": (cfg, False),
            "VIO, accelerometer reads gravity only": (cfg, True),
            "VIO, Madgwick beta 0": (cfg.replace(vio=VioConfig(madgwick_beta=0.0)), False),
            "VIO, RP blend 0": (cfg.replace(vio=VioConfig(rp_blend=0.0)), False),
            "VIO, bias gains 0": (cfg.replace(vio=VioConfig(
                acc_bias_gain=0.0, gyro_bias_gain=0.0)), False),
        }
        for name, (vcfg, grav) in variants.items():
            c, inl, st = single(i0, i1, poses, c=vcfg, gravity_only=grav)
            report(name, c, gt, inl, st)
        i0, i1, poses, gt = sequence(4 * T, 0)
        for name, use_imu in (("quarter speed, vision only", False),
                              ("quarter speed, VIO", True)):
            c, inl, st = single(i0, i1, poses, use_imu=use_imu)
            report(name, c, gt, inl, st)
        return

    seqs = [sequence(T, s) for s in range(S)]
    frame_t, accs, gyros, ts = imu(seqs[0][2])
    a, g, t, v = pack_imu_frames(accs, gyros, ts, 16)
    alone = []
    for s, (i0, i1, poses, gt) in enumerate(seqs):
        c, inl, st = single(i0, i1, poses)
        alone.append(c)
        report(f"seq {s} alone", c, gt, inl, st)
    shipped = multiseq._batched_fcfg
    for rescue, groups in ((False, [list(range(S))]),
                           (False, [[s] for s in range(S)]),
                           (True, [list(range(S))])):
        multiseq._batched_fcfg = (lambda c: c) if rescue else shipped
        jax.clear_caches()
        t0 = time.perf_counter()
        for grp in groups:
            n = len(grp)
            bc = lambda x: np.broadcast_to(x, (n,) + np.shape(x)).copy()
            msl = MultiSeqSlam(cfg, cam, num_seqs=n, use_imu=True, use_loop=False)
            packed = msl.process_chunk_vio(
                np.stack([seqs[s][0] for s in grp]),
                np.stack([seqs[s][1] for s in grp]),
                bc(np.asarray(frame_t, np.float32)), bc(a), bc(g), bc(t), bc(v))
            for k, s in enumerate(grp):
                report(f"seq {s} batched over {n}, rescue {'on' if rescue else 'off'}",
                       msl.trajectory_cam_centers(k), seqs[s][3], packed[k, :, 3],
                       packed[k, :, 2], ref=alone[s])
        print(f"  {time.perf_counter() - t0:.1f} s", flush=True)
    multiseq._batched_fcfg = shipped


if __name__ == "__main__":
    main()
