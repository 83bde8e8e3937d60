"""A REAL 2-process jax.distributed run (DCN path, SURVEY.md §7.8).

Subprocess-launches two CPU worker processes (tests/multihost_worker.py)
with a localhost coordinator, each owning 2 virtual devices / 2 sequences
of a 4-sequence full-system DP chunk, and asserts the distributed
trajectories match the single-process fused chunk per sequence — the
multi-host steady-state path that round 2 had only exercised in its no-op
and error branches.

Marked slow: two fresh interpreters + CPU XLA compiles (~2 min on the
2-CPU box).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_two_process_distributed_matches_single(tmp_path):
    port = 47123
    env_base = {
        **os.environ,
        "PYTHONPATH": REPO,
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
    }
    # Drop any interpreter-start hook that imports jax: it would touch a
    # backend BEFORE jax.distributed.initialize.
    env_base.pop("PYTHONSTARTUP", None)
    procs = []
    for pid in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests",
                                          "multihost_worker.py"),
             f"127.0.0.1:{port}", "2", str(pid), str(tmp_path)],
            env=env_base, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            cwd=REPO))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode())
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"worker {pid}: OK (2 processes, 4 global devices)" in out

    # Each process dumped only its own sequence shards: 0-1 on proc0,
    # 2-3 on proc1 (contiguous blocks by construction).
    d0 = np.load(tmp_path / "proc0.npz")
    d1 = np.load(tmp_path / "proc1.npz")
    assert {k for k in d0.files if k.startswith("t_")} == {"t_0", "t_1"}
    assert {k for k in d1.files if k.startswith("t_")} == {"t_2", "t_3"}

    # Single-process reference: the fused chunk per sequence.
    import jax.numpy as jnp
    from flvis_tpu.backend import window_ba
    from flvis_tpu.config import BackendConfig, FrontendConfig
    from flvis_tpu.frontend import tracker
    from flvis_tpu.geometry import camera
    from flvis_tpu.io.synthetic import (PlanarScene, SceneConfig,
                                        orbit_trajectory)
    from flvis_tpu.pipeline import runner as runner_m

    fcfg = FrontendConfig(width=256, height=192, num_slots=64,
                          pyramid_levels=3, per_cell=4, min_distance=10.0,
                          margin=12, lk_radius=7, ransac_hypotheses=32,
                          kf_bootstrap_every=2)
    bcfg = BackendConfig(window_size=4, max_landmarks=128, min_views=2,
                         iters1=4, iters2=3)
    cam = camera.make(200.0, 200.0, 128.0, 96.0, 0.12,
                      width=256, height=192)
    scfg = SceneConfig(width=256, height=192, fx=200.0, fy=200.0,
                       cx=128.0, cy=96.0, baseline=0.12)
    for s, d in ((0, d0), (1, d0), (2, d1), (3, d1)):
        scene = PlanarScene(scfg, plane_depth=8.0, seed=s)
        frames = [scene.render(R, t)
                  for (R, t) in orbit_trajectory(3, step=0.04)]
        i0 = jnp.asarray(np.stack([f[0] for f in frames]))
        i1 = jnp.asarray(np.stack([f[1] for f in frames]))
        _, _, _, ys = runner_m._chunk_fused(
            fcfg, bcfg, cam, tracker.init_state(fcfg),
            window_ba.empty(bcfg), window_ba.null_correction(bcfg), i0, i1)
        out_ref = ys[0]
        np.testing.assert_array_equal(d[f"status_{s}"],
                                      np.asarray(out_ref.status))
        # Same rounding-order caveat as the single-process DP parity test
        # (vmap batches reductions differently): sub-mm agreement.
        np.testing.assert_allclose(d[f"t_{s}"],
                                   np.asarray(out_ref.T_c_w.t), atol=1e-3)


@pytest.mark.slow
def test_two_process_weak_scaling(tmp_path):
    """Weak-scaling efficiency on the only hardware available: 1 vs 2
    processes, one physical core + one device + one sequence EACH (taskset
    pins each worker to its own core, so per-process compute is constant and
    the ratio isolates orchestration/lockstep losses).  This
    localhost-loopback number bounds the framework-side losses only."""

    def run(nproc: int, port: int):
        env = {
            **os.environ,
            "PYTHONPATH": REPO,
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
        }
        env.pop("PYTHONSTARTUP", None)
        procs = []
        for pid in range(nproc):
            procs.append(subprocess.Popen(
                ["taskset", "-c", str(pid), sys.executable,
                 os.path.join(REPO, "tests", "multihost_worker.py"),
                 f"127.0.0.1:{port}", str(nproc), str(pid), str(tmp_path),
                 "timed"],
                env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, cwd=REPO))
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            outs.append(out.decode())
        for pid, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"worker {pid} failed:\n{out}"
            assert "TIMED OK" in out
        walls, frames = [], 0
        for pid in range(nproc):
            d = np.load(tmp_path / f"timed{pid}.npz")
            walls.append(float(d["wall"]))
            frames += int(d["frames"])
        return frames / max(walls)          # aggregate frames/s

    fps1 = run(1, 47211)
    agg2 = run(2, 47213)
    eff = agg2 / (2.0 * fps1)
    print(f"weak scaling: 1-proc {fps1:.2f} fps, 2-proc agg {agg2:.2f} fps, "
          f"efficiency {eff:.3f}")
    (tmp_path / "efficiency.txt").write_text(str(eff))
    # Loose floor: CPU-core contention jitter on small hosts.
    assert eff > 0.5, eff
