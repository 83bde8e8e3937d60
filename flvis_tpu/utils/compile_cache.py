"""Where the persistent XLA compile cache lives.

The fused chunk programs take long to compile, and JAX keys its persistent
cache partly on the cache path, so the path must not move between runs.
`JAX_COMPILATION_CACHE_DIR`, when set, wins and no other directory is set.
Otherwise the cache goes to `.jax_cache/` at the root of the checkout.
CPU executables go one level deeper, into a directory named after the
host's CPU feature flags: XLA:CPU cache keys ignore the host CPU, and an
executable built for another CPU generation can crash on load (SIGILL).
"""

from __future__ import annotations

import hashlib
import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _cpu_tag() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            flags = next(line for line in f if line.startswith("flags"))
    except (OSError, StopIteration):
        import platform

        flags = platform.processor() or "unknown"
    return hashlib.sha1(flags.encode()).hexdigest()[:10]


def cache_dir(cpu: bool) -> str:
    """The cache directory for a CPU (`cpu=True`) or GPU process."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(CHECKOUT, ".jax_cache")
    return os.path.join(path, f"machine-{_cpu_tag()}") if cpu else path


def enable(cpu: bool) -> str:
    """Point JAX's persistent compile cache at cache_dir(cpu); returns it."""
    path = cache_dir(cpu)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
