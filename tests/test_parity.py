"""Device ops against independent numpy references at the bench operating
point (flvis_tpu.utils.parity), plus the checks that keep the program
free of platform-specific paths and the GPU smoke script honest.

Run here on the CPU; tests/test_chip.py runs the same checks on the GPU.
"""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flvis_tpu.ops import image as imops
from flvis_tpu.utils import compile_cache, parity

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", sorted(parity.CHECKS))
def test_parity(name):
    summary = parity.CHECKS[name]()
    assert summary.startswith(name)


class TestGatherBlocks:
    def test_extract_patches_int_at_the_border(self):
        """Integer centres on and just past the image edge replicate the
        edge pixels (the padding absorbs every clipped corner)."""
        rng = np.random.default_rng(0)
        img = rng.uniform(0, 255, (48, 64)).astype(np.float32)
        r = 3
        centers = np.array([[0, 0], [63, 47], [-5, 10], [70, 50], [31, 20]])
        got = np.asarray(imops.extract_patches_int(
            jnp.asarray(img), jnp.asarray(centers, jnp.float32), r))
        ys = np.arange(-r, r + 1)
        for (x, y), patch in zip(centers, got):
            x, y = np.clip(x, -1, 64), np.clip(y, -1, 48)
            rows = np.clip(y + ys, 0, 47)
            cols = np.clip(x + ys, 0, 63)
            np.testing.assert_array_equal(patch, img[np.ix_(rows, cols)])

    def test_extract_windows_negative_corners(self):
        """Window corners may start left of / above the image: edge padding
        supplies replicated pixels, and the returned corners say where."""
        rng = np.random.default_rng(1)
        img = rng.uniform(0, 255, (40, 50)).astype(np.float32)
        win = 9
        corners = np.array([[-4, -3], [45, 35], [-20, 0], [10, 12]])
        wins, eff = imops.extract_windows(
            jnp.asarray(img), jnp.asarray(corners, jnp.float32), win)
        wins, eff = np.asarray(wins), np.asarray(eff)
        np.testing.assert_array_equal(eff, np.clip(corners, -win, [50, 40]))
        for (cx, cy), w in zip(eff, wins):
            rows = np.clip(cy + np.arange(win), 0, 39)
            cols = np.clip(cx + np.arange(win), 0, 49)
            np.testing.assert_array_equal(w, img[np.ix_(rows, cols)])

    def test_multichannel_blocks_match_per_channel(self):
        rng = np.random.default_rng(2)
        stack = rng.uniform(0, 255, (3, 30, 40)).astype(np.float32)
        cx = jnp.asarray([0, 28, 5], jnp.int32)
        cy = jnp.asarray([0, 18, 7], jnp.int32)
        got = np.asarray(imops._gather_blocks(jnp.asarray(stack), cx, cy, 12))
        for c in range(3):
            one = np.asarray(imops._gather_blocks(jnp.asarray(stack[c]),
                                                  cx, cy, 12))
            np.testing.assert_array_equal(got[:, c], one)


class TestCompileCache:
    def test_env_var_wins(self, monkeypatch, tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache.cache_dir(cpu=True) == str(tmp_path)
        assert compile_cache.cache_dir(cpu=False) == str(tmp_path)

    def test_fixed_path_in_checkout(self, monkeypatch):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        gpu = pathlib.Path(compile_cache.cache_dir(cpu=False))
        cpu = pathlib.Path(compile_cache.cache_dir(cpu=True))
        assert gpu == ROOT / ".jax_cache"
        assert cpu.parent == gpu and cpu.name.startswith("machine-")
        assert compile_cache.cache_dir(cpu=True) == str(cpu)    # stable

    def test_enable_sets_jax_config(self, monkeypatch, tmp_path):
        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        try:
            assert compile_cache.enable(cpu=True) == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        finally:
            jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_the_cpu(alone, tmp_path):
    """Without a GPU, or copied away from the package, the smoke script
    exits non-zero and prints no result."""
    script = ROOT / "chip_smoke.py"
    if alone:
        script = pathlib.Path(shutil.copy(script, tmp_path))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert ("No module named 'flvis_tpu'" if alone else "not a GPU") in r.stderr


def test_no_platform_branches():
    """One path per op: no TPU kernel import, no branch on the platform
    name, no interpret-mode switch in the program."""
    pattern = re.compile(
        r'pallas\.tpu|pltpu|default_backend\(\) *[!=]= *"tpu"|interpret *=|'
        r'["\']tpu["\']')
    files = [ROOT / "bench.py", ROOT / "chip_smoke.py",
             ROOT / "__graft_entry__.py",
             *(ROOT / "flvis_tpu").rglob("*.py"),
             *(ROOT / "examples").rglob("*.py")]
    hits = [f"{f.relative_to(ROOT)}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pattern.search(line)]
    assert not hits, hits
    assert not (ROOT / "flvis_tpu" / "ops" / "pallas").exists()
