"""Test configuration.

Tests run on the CPU with 8 virtual devices (the multi-device sharding
tests need a mesh), whatever accelerator the machine has.  Tests that need
the card are marked `chip`: `pytest -m chip` leaves the platform to JAX so
they see the GPU (and skip where there is none).  XLA_FLAGS is read when
the backend initializes, which has not happened yet at conftest import.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from flvis_tpu.utils import compile_cache  # noqa: E402


def pytest_configure(config):
    on_chip = (config.option.markexpr or "").strip() == "chip"
    if not on_chip:
        jax.config.update("jax_platforms", "cpu")
    # The suite's wall time is dominated by XLA compiles of the fused-chunk
    # programs; the persistent cache keeps them across runs.
    compile_cache.enable(cpu=not on_chip)


import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Release compiled-program memory between test modules.

    The suite compiles ~160 distinct jit signatures; on the 2-CPU box the
    accumulated compile-cache memory segfaulted XLA at ~95% of a single-
    process run (round-1 verdict).  Dropping caches per module bounds the
    growth; tests/run_all.py remains as the per-file-subprocess fallback.
    """
    yield
    jax.clear_caches()
