#!/usr/bin/env python
"""Smoke test of the SLAM engine on NVIDIA GPUs.

    python chip_smoke.py           # one GPU: phases 0, 1 and 2
    python chip_smoke.py --four    # four GPUs: the multi-device paths only

Phase 0 requires JAX's default backend to be the GPU and prints the card's
name and power limit.  There is no CPU fallback: any other platform exits
non-zero before a result is printed.

Phase 1 compares every device op of the main path with a plain numpy
reference at the bench operating point — 752×480 stereo, 256 landmark
slots, 3 pyramid levels, ORB-1000, a 4096-word vocabulary, a 10-keyframe ×
600-landmark window (flvis_tpu.utils.parity; each line states its
tolerance and why).

Phase 2 drives the main path through its user entry points:
`SlamSystem(use_imu=True, use_loop=True, pipelined=True).process_frames_vio`
over four 64-frame chunks of a closed synthetic trajectory with
trajectory-consistent IMU, then a 256-frame out-and-back revisit through
`SlamSystem(use_loop=True, pipelined=True)`.  Every frame must be TRACKING,
the ATE must stay under 2 % of the path, the loop node must ingest
keyframes, and the revisit must accept a closure and run the pose graph.
Last, one 8-frame tracking chunk runs on the GPU and on the CPU in this
process and the two are compared.

With --four, only the multi-device paths run, each against the same work
on one card: four sequences data-parallel over a 4-device mesh
(MultiSeqSlam with IMU and a loop node per sequence), and the loop node on
its own card (SlamSystem(loop_device=...)).

Frames come from flvis_tpu.io.synthetic (exact ground truth), made from
fixed seeds.  The last line of standard output is one JSON object naming
the device; it is printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback

import numpy as np

CHUNK = 64
CHUNKS = 4


def card_lines() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


class Phases:
    """Runs each phase, printing its wall time beside the card's name and
    power limit.  A failing phase is reported and recorded, and the next
    one still runs, so one run shows every failure; main() then exits
    non-zero without a result."""

    def __init__(self, card: str):
        self.card = card
        self.failed: list[str] = []

    def run(self, name: str, fn):
        t0 = time.perf_counter()
        try:
            fn()
            verdict = "ok"
        except Exception:
            traceback.print_exc()
            self.failed.append(name)
            verdict = "FAILED"
        print(f"[{self.card}] {name}: {verdict}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


def _camera():
    from flvis_tpu.geometry import camera
    from flvis_tpu.io.synthetic import SceneConfig

    scfg = SceneConfig(width=752, height=480, fx=458.0, fy=458.0, cx=376.0,
                       cy=240.0, baseline=0.11)
    cam = camera.make(scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline,
                      width=752, height=480)
    return scfg, cam


def _u8(a):
    return np.clip(np.round(np.asarray(a)), 0, 255).astype(np.uint8)


def _render(poses, seed=0):
    from flvis_tpu.io.synthetic import PlanarScene

    scfg, _ = _camera()
    scene = PlanarScene(scfg, plane_depth=8.0, seed=seed)
    frames = [scene.render(R, t) for R, t in poses]
    return (np.stack([_u8(f[0]) for f in frames]),
            np.stack([_u8(f[1]) for f in frames]))


def _imu_per_frame(poses, fps=20.0):
    from flvis_tpu.io.synthetic import imu_from_trajectory

    t_imu, gyro, acc, frame_t = imu_from_trajectory(poses, fps=fps)
    accs, gyros, ts = [], [], []
    prev = -np.inf
    for ft in frame_t:
        sel = (t_imu > prev) & (t_imu <= ft)
        accs.append(acc[sel]); gyros.append(gyro[sel]); ts.append(t_imu[sel])
        prev = ft
    return frame_t, accs, gyros, ts


def _revisit_poses(n=CHUNK * CHUNKS):
    """Out-and-back along x: the second half revisits the first's views."""
    half = n // 2
    xs = np.concatenate([np.linspace(0.0, 0.02 * half, half),
                         np.linspace(0.02 * half, 0.01, n - half)])
    return [(np.eye(3), -np.asarray([x, 0.0, 0.0])) for x in xs]


def _ate(centers, poses):
    from flvis_tpu.utils import evaluation

    gt = np.asarray([-R.T @ t for R, t in poses])
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
    ate, _ = evaluation.ate_rmse(centers, gt)
    return ate, path


def _system_config(**loop):
    import dataclasses

    from flvis_tpu.config import SystemConfig, bench_frontend_config

    cfg = SystemConfig(frontend=bench_frontend_config())
    return cfg.replace(loop=dataclasses.replace(cfg.loop, **loop))


def _statuses(outs):
    return np.concatenate([np.asarray(o.status) for o in outs if o is not None])


def phase_vio_loop():
    """The EuRoC-shaped headline configuration: stereo + IMU + loop."""
    from flvis_tpu.io.synthetic import periodic_trajectory
    from flvis_tpu.pipeline.runner import SlamSystem

    n = CHUNK * CHUNKS
    poses = periodic_trajectory(n)
    i0, i1 = _render(poses)
    frame_t, accs, gyros, imu_t = _imu_per_frame(poses)
    _, cam = _camera()
    slam = SlamSystem(_system_config(), cam, use_imu=True, use_loop=True,
                      pipelined=True)
    outs = []
    for c in range(CHUNKS):
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        outs.append(slam.process_frames_vio(
            i0[sl], i1[sl], frame_t[sl], accs[sl], gyros[sl], imu_t[sl]))
    outs.append(slam.flush())
    status = _statuses(outs)
    ate, path = _ate(slam.trajectory_cam_centers(), poses)
    kfs, ingested = len(slam.keyframes), slam.loop_closer.count
    print(f"  vio+loop: {len(status)} frames, tracking "
          f"{int(np.sum(status == 1))}, ATE {ate:.4f} m over {path:.2f} m "
          f"(bound {0.02 * path + 0.01:.4f}), keyframes {kfs}, loop-node "
          f"ingested {ingested}", flush=True)
    assert len(status) == n and np.all(status == 1), "a frame left TRACKING"
    assert ate < 0.02 * path + 0.01, ate
    assert ingested == kfs > 0, (ingested, kfs)


def run_revisit(loop_device=None):
    """256-frame out-and-back through SlamSystem(use_loop=True)."""
    from flvis_tpu.pipeline.runner import SlamSystem

    poses = _revisit_poses()
    i0, i1 = _render(poses)
    _, cam = _camera()
    slam = SlamSystem(_system_config(), cam, use_loop=True, pipelined=True,
                      loop_device=loop_device)
    outs = [slam.process_frames(i0[c:c + CHUNK], i1[c:c + CHUNK])
            for c in range(0, len(poses), CHUNK)]
    outs.append(slam.flush())
    return slam, poses, _statuses(outs)


def phase_revisit():
    slam, poses, status = run_revisit()
    lc = slam.loop_closer
    ate, path = _ate(slam.trajectory_cam_centers(), poses)
    pgo_ran = lc._last_pgo_id >= 0
    print(f"  revisit: {len(status)} frames, tracking "
          f"{int(np.sum(status == 1))}, ATE {ate:.4f} m over {path:.2f} m "
          f"(bound {0.02 * path + 0.01:.4f}), keyframes {len(slam.keyframes)},"
          f" closures accepted {len(lc.closures)}, PGO ran {pgo_ran}",
          flush=True)
    assert np.all(status == 1), "a frame left TRACKING"
    assert ate < 0.02 * path + 0.01, ate
    assert lc.count == len(slam.keyframes) > 0
    assert len(lc.closures) >= 1 and pgo_ran, "no loop closed"


def phase_parity(phases):
    from flvis_tpu.utils import parity

    for name, check in parity.CHECKS.items():
        phases.run(f"phase 1 {name}", lambda: print("  " + check(), flush=True))


def run_one_card(phases):
    from flvis_tpu.utils import parity

    phase_parity(phases)
    phases.run("phase 2 vio+loop (4 x 64 frames)", phase_vio_loop)
    phases.run("phase 2 revisit (256 frames)", phase_revisit)
    phases.run("phase 2 8-frame chunk, GPU vs CPU",
               lambda: print("  " + parity.check_scan_vs_cpu(8), flush=True))


def _traj_diff(a, b):
    return float(np.max(np.linalg.norm(np.asarray(a) - np.asarray(b), axis=-1)))


def phase_multiseq_four():
    """Four sequences data-parallel over a 4-device mesh, each against the
    same sequence run alone on one card.

    Tolerances: every frame TRACKING in both runs, the same keyframes
    ingested, and per sequence the ATE and the median frame within 1 mm of
    the one-card run.  The worst frame is printed, not bounded: two XLA
    programs of the same float32 math on ONE card (this step batched over
    four sequences, and over one) differ by up to 5.5e-2 m at single
    frames of these sequences while their ATE moves by < 1e-3 m; the
    tracker amplifies rounding differences at marginal frames.  A sequence
    placed on the wrong card or mixed with another is off by decimetres
    (the sequences start 0.4 m apart).  The ATE of SlamSystem on each
    sequence alone is printed beside them: at this path's accelerations
    the VIO's error exceeds the 2 % bound of phase 2 on one card as well
    (examples/fast_motion_vio.py)."""
    import jax

    from flvis_tpu.io.synthetic import periodic_trajectory
    from flvis_tpu.parallel import multiseq
    from flvis_tpu.parallel.multiseq_loop import MultiSeqSlam
    from flvis_tpu.pipeline.runner import SlamSystem, pack_imu_frames

    S = 4
    # One full period of the closed path in 64 frames: lateral
    # accelerations up to 1.2 m/s^2, four times phase 2's per-frame motion.
    poses = periodic_trajectory(CHUNK)
    frame_t, accs, gyros, imu_t = _imu_per_frame(poses)
    a, g, t, v = pack_imu_frames(accs, gyros, imu_t, 16)
    # Distinct sequences: the same motion, started 0.4 m apart along the
    # plane, so each sequence sees other texture (same IMU readings).
    seq_poses = [[(R, t - R @ np.array([0.4 * s, 0.0, 0.0])) for R, t in poses]
                 for s in range(S)]
    seq_i0, seq_i1 = map(np.stack, zip(*map(_render, seq_poses)))
    _, cam = _camera()
    cfg = _system_config(kf_start=8)

    def run(mesh, seqs):
        n = len(seqs)
        bc = lambda x: np.broadcast_to(x, (n,) + np.shape(x)).copy()
        msl = MultiSeqSlam(cfg, cam, num_seqs=n, use_imu=True, use_loop=True,
                           mesh=mesh, pipelined=True)
        outs = [msl.process_chunk_vio(
            seq_i0[seqs], seq_i1[seqs], bc(np.asarray(frame_t, np.float32)),
            bc(a), bc(g), bc(t), bc(v)), msl.flush()]
        status = np.concatenate([o[:, :, 2] for o in outs if o is not None],
                                axis=1)
        return msl, status

    sharded, status4 = run(multiseq.make_mesh(4), list(range(S)))
    leaf = sharded.fe.T_c_w.t
    shard_devs = [sh.device for sh in leaf.addressable_shards]
    rows = [sh.index[0] for sh in leaf.addressable_shards]
    assert len(set(shard_devs)) == S == len(jax.devices()), shard_devs
    assert sorted((r.start, r.stop) for r in rows) == [(s, s + 1)
                                                      for s in range(S)], rows
    bad = []
    for s in range(S):
        one, status1 = run(None, [s])
        alone = SlamSystem(cfg, cam, use_imu=True, use_loop=False)
        alone.process_frames_vio(seq_i0[s], seq_i1[s], frame_t, accs, gyros,
                                 imu_t)
        ca = sharded.trajectory_cam_centers(s)
        cb = one.trajectory_cam_centers(0)
        (ate4, path), (ate1, _) = _ate(ca, seq_poses[s]), _ate(cb, seq_poses[s])
        ate_alone, _ = _ate(alone.trajectory_cam_centers(), seq_poses[s])
        d = np.linalg.norm(ca - cb, axis=-1)
        kfs = (sharded.loopers[s].count, one.loopers[0].count)
        tracking = (int(np.sum(status4[s] == 1)), int(np.sum(status1[0] == 1)))
        print(f"  seq {s} on {shard_devs[s]}: {len(ca)} frames, tracking "
              f"{tracking[0]} vs {tracking[1]} on one card, ATE {ate4:.4f} m "
              f"vs {ate1:.4f} m over {path:.2f} m (tol 1e-3), median |4-card "
              f"- 1-card| {np.median(d):.2e} m (tol 1e-3), worst frame "
              f"{d.max():.2e} m, keyframes ingested {kfs[0]} vs {kfs[1]}; "
              f"SlamSystem alone: ATE {ate_alone:.4f} m", flush=True)
        if not (len(ca) == len(cb) == CHUNK and tracking == (CHUNK, CHUNK)
                and abs(ate4 - ate1) <= 1e-3 and np.median(d) <= 1e-3
                and kfs[0] == kfs[1] > 0):
            bad.append(s)
    assert not bad, f"sequences {bad} out of bounds"


def phase_loop_device_four():
    """The whole loop node on the second card vs everything on the first:
    the same closures and drift-corrected trajectories within 1 mm."""
    import jax

    dev1 = jax.devices()[1]
    split, poses, status_a = run_revisit(loop_device=dev1)
    one, _, status_b = run_revisit()
    lc = split.loop_closer
    placed = lc.kf_desc.devices() | lc.kf_q.devices()
    pairs_a = [(c.kf_i, c.kf_j) for c in lc.closures]
    pairs_b = [(c.kf_i, c.kf_j) for c in one.loop_closer.closures]
    d = _traj_diff(split.trajectory_cam_centers(loop_corrected=True),
                   one.trajectory_cam_centers(loop_corrected=True))
    print(f"  loop node on {sorted(map(str, placed))}: closures "
          f"{len(pairs_a)} vs {len(pairs_b)} on one card, max |corrected "
          f"trajectory difference| {d:.2e} m (tol 1e-3)", flush=True)
    assert placed == {dev1}, placed
    assert np.all(status_a == 1) and np.all(status_b == 1)
    assert pairs_a == pairs_b and len(pairs_a) >= 1, (pairs_a, pairs_b)
    assert d <= 1e-3, d


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU paths and their one-GPU "
                         "references")
    args = ap.parse_args(argv)

    import jax

    from flvis_tpu.utils import compile_cache

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: JAX's default backend is {backend!r}, not a GPU",
              file=sys.stderr)
        return 1
    devices = jax.devices()
    want = 4 if args.four else 1
    if len(devices) < want:
        print(f"chip_smoke: {len(devices)} GPU(s), {want} needed",
              file=sys.stderr)
        return 1
    compile_cache.enable(cpu=False)
    cards = card_lines()
    for line in cards:
        print(line, flush=True)
    d0 = devices[0]
    print(f"phase 0: platform {d0.platform}, kind {d0.device_kind}, "
          f"count {len(devices)}", flush=True)
    phases = Phases(cards[0])
    t0 = time.perf_counter()
    if args.four:
        phases.run("four: sequence data parallelism (4 x 64 frames)",
                   phase_multiseq_four)
        phases.run("four: loop node on its own card (256 frames)",
                   phase_loop_device_four)
    else:
        run_one_card(phases)
    print(f"[{cards[0]}] total: {time.perf_counter() - t0:.1f} s", flush=True)
    if phases.failed:
        print(f"chip_smoke: failed: {', '.join(phases.failed)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
