"""Worker process for the REAL 2-process jax.distributed test.

Launched by tests/test_multihost_2proc.py as two separate CPU processes
(the reference's equivalent scale-out is one ROS process per sequence,
SURVEY.md §2.3).  Each process:

  1. wires into the distributed runtime (multihost.initialize — coordinator
     on 127.0.0.1) BEFORE touching any backend,
  2. builds the GLOBAL mesh over both processes' CPU devices,
  3. loads only its own host-local sequence block (multihost.
     host_sequence_slice + make_global_batch — images never cross "DCN"),
  4. runs the full-system multi-sequence DP chunk (multiseq.
     system_chunk_batch) over the global `seq` axis,
  5. dumps the trajectories of its ADDRESSABLE sequence shards to an .npz
     for the parent test to compare against the single-process run.

Usage: python tests/multihost_worker.py <coord> <nproc> <pid> <outdir> [mode]
Env:   JAX_PLATFORMS=cpu, XLA_FLAGS=--xla_force_host_platform_device_count=2
       (2 local devices per process → 4 global devices / 4 sequences).

mode "timed": the WEAK-SCALING harness (1 device + 1 sequence per process,
parent pins each process to its own physical core) — times the steady-state
DP chunk loop and dumps per-process wall time, so the parent can compute
aggregate-fps(P processes) / (P × fps(1 process)): the only scaling-
efficiency evidence obtainable without second-host hardware (the "DCN" is
localhost loopback, so it bounds orchestration + lockstep losses, not real
network).
"""

import sys


def main():
    coord, nproc, pid, outdir = sys.argv[1:5]
    mode = sys.argv[5] if len(sys.argv) > 5 else "parity"
    import numpy as np

    from flvis_tpu.parallel import multihost

    multihost.initialize(coord, int(nproc), int(pid))
    if mode == "timed":
        return timed_main(int(nproc), int(pid), outdir)
    import jax
    import jax.numpy as jnp

    assert jax.process_count() == int(nproc), jax.process_count()
    from flvis_tpu.config import BackendConfig, FrontendConfig
    from flvis_tpu.geometry import camera
    from flvis_tpu.io.synthetic import (PlanarScene, SceneConfig,
                                        orbit_trajectory)
    from flvis_tpu.parallel import multiseq

    S, T = 4, 3
    fcfg = FrontendConfig(width=256, height=192, num_slots=64,
                          pyramid_levels=3, per_cell=4, min_distance=10.0,
                          margin=12, lk_radius=7, ransac_hypotheses=32,
                          kf_bootstrap_every=2)
    bcfg = BackendConfig(window_size=4, max_landmarks=128, min_views=2,
                         iters1=4, iters2=3)
    mesh = multiseq.make_mesh()            # all 4 GLOBAL devices
    assert mesh.shape["seq"] == 4, mesh.shape
    cam1 = camera.make(200.0, 200.0, 128.0, 96.0, 0.12,
                       width=256, height=192)
    scfg = SceneConfig(width=256, height=192, fx=200.0, fy=200.0,
                       cx=128.0, cy=96.0, baseline=0.12)

    # Host-local block only: this process renders just its own sequences.
    sl = multihost.host_sequence_slice(S, mesh)
    local = []
    for s in range(S)[sl]:
        scene = PlanarScene(scfg, plane_depth=8.0, seed=s)
        frames = [scene.render(R, t)
                  for (R, t) in orbit_trajectory(T, step=0.04)]
        local.append((np.stack([f[0] for f in frames]),
                      np.stack([f[1] for f in frames])))
    imgs0, imgs1 = multihost.make_global_batch(
        mesh, (np.stack([x[0] for x in local]),
               np.stack([x[1] for x in local])))
    cams = multihost.make_global_batch(
        mesh, jax.tree.map(
            lambda a: np.broadcast_to(
                np.asarray(a), (len(local),) + np.shape(np.asarray(a))),
            cam1))
    fe_b, ba_b, corr_b = multihost.init_system_states_global(
        fcfg, bcfg, S, mesh)
    _, _, _, outs, costs = multiseq.system_chunk_batch_sharded(
        mesh, fcfg, bcfg, cams, fe_b, ba_b, corr_b, imgs0, imgs1)

    # Dump only this process's addressable sequence shards.
    dump = {}
    for name, arr in (("t", outs.T_c_w.t), ("q", outs.T_c_w.q),
                      ("status", outs.status), ("kf", outs.is_keyframe)):
        for shard in arr.addressable_shards:
            s0 = shard.index[0].start or 0
            for off in range(shard.data.shape[0]):
                dump[f"{name}_{s0 + off}"] = np.asarray(shard.data[off])
    np.savez(f"{outdir}/proc{pid}.npz", **dump)
    print(f"worker {pid}: OK ({jax.process_count()} processes, "
          f"{len(jax.devices())} global devices)")


def timed_main(nproc: int, pid: int, outdir: str):
    """Weak-scaling timing: one sequence on this process's one device,
    lockstepped with the other processes through the global `seq` mesh —
    the same per-process work at every process count."""
    import time

    import numpy as np
    import jax
    import jax.numpy as jnp

    from flvis_tpu.config import BackendConfig, FrontendConfig
    from flvis_tpu.geometry import camera
    from flvis_tpu.io.synthetic import (PlanarScene, SceneConfig,
                                        orbit_trajectory)
    from flvis_tpu.parallel import multihost, multiseq

    import os
    assert jax.process_count() == nproc
    S, T = nproc, int(os.environ.get("FLVIS_TIMED_T", "8"))
    fcfg = FrontendConfig(width=256, height=192, num_slots=64,
                          pyramid_levels=3, per_cell=4, min_distance=10.0,
                          margin=12, lk_radius=7, ransac_hypotheses=32,
                          kf_bootstrap_every=2)
    bcfg = BackendConfig(window_size=4, max_landmarks=128, min_views=2,
                         iters1=4, iters2=3)
    mesh = multiseq.make_mesh()
    assert mesh.shape["seq"] == nproc, mesh.shape
    cam1 = camera.make(200.0, 200.0, 128.0, 96.0, 0.12,
                       width=256, height=192)
    scfg = SceneConfig(width=256, height=192, fx=200.0, fy=200.0,
                       cx=128.0, cy=96.0, baseline=0.12)
    scene = PlanarScene(scfg, plane_depth=8.0, seed=pid)
    frames = [scene.render(R, t)
              for (R, t) in orbit_trajectory(T, step=0.04)]
    imgs0, imgs1 = multihost.make_global_batch(
        mesh, (np.stack([f[0] for f in frames])[None],
               np.stack([f[1] for f in frames])[None]))
    cams = multihost.make_global_batch(
        mesh, jax.tree.map(
            lambda a: np.broadcast_to(np.asarray(a),
                                      (1,) + np.shape(np.asarray(a))),
            cam1))
    fe_b, ba_b, corr_b = multihost.init_system_states_global(
        fcfg, bcfg, S, mesh)

    def step():
        nonlocal fe_b, ba_b, corr_b
        # shard_map wrapper: zero cross-process collectives (the GSPMD
        # auto-partitioned program carried 56 all-gathers + 156 all-reduces
        # that rode gloo every step — see multiseq.py module note).
        fe_b, ba_b, corr_b, outs, _ = multiseq.system_chunk_batch_sharded(
            mesh, fcfg, bcfg, cams, fe_b, ba_b, corr_b, imgs0, imgs1)
        return outs

    from jax.experimental import multihost_utils

    def barrier(x):
        # Fetch this process's ADDRESSABLE shards (forces local completion;
        # a global fetch of a cross-process array is not possible), then a
        # cross-process rendezvous so every process leaves together.
        for sh in x.T_c_w.t.addressable_shards:
            np.asarray(sh.data)
        multihost_utils.sync_global_devices("timed-barrier")

    if os.environ.get("FLVIS_TIMED_DEBUG"):
        print(f"worker {pid} imgs0 sharding: {imgs0.sharding} "
              f"local shards: {[sh.data.shape for sh in imgs0.addressable_shards]}",
              flush=True)
    for _ in range(3):                       # compile + steady-state warm
        outs = step()
    barrier(outs)
    if os.environ.get("FLVIS_TIMED_DEBUG"):
        print(f"worker {pid} outs sharding: {outs.T_c_w.t.sharding} "
              f"local: {[sh.data.shape for sh in outs.T_c_w.t.addressable_shards]}",
              flush=True)
    reps = int(os.environ.get("FLVIS_TIMED_REPS", "4"))
    if os.environ.get("FLVIS_TIMED_DEBUG"):
        for k in range(4):
            t0 = time.perf_counter()
            outs = step()
            for sh in outs.T_c_w.t.addressable_shards:
                np.asarray(sh.data)
            print(f"worker {pid} step {k}: "
                  f"{time.perf_counter() - t0:.3f}s", flush=True)
    t0 = time.perf_counter()
    for _ in range(reps):
        outs = step()
    barrier(outs)
    wall = time.perf_counter() - t0
    np.savez(f"{outdir}/timed{pid}.npz",
             wall=np.asarray(wall), frames=np.asarray(reps * T))
    print(f"worker {pid}: TIMED OK ({nproc} processes, wall {wall:.3f}s)")


if __name__ == "__main__":
    main()
