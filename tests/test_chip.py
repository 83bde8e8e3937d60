"""On-card parity: the checks of tests/test_parity.py, and the 8-frame
GPU-vs-CPU tracking chunk, run on the GPU.

    python -m pytest tests/test_chip.py -m chip

Under the default CPU-forced test run these skip.  Run them in a process
of their own (no `-n`): a JAX process reserves most of the card's memory.
"""

import jax
import pytest

from flvis_tpu.utils import parity

pytestmark = pytest.mark.chip


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with -m chip on the card)")


@pytest.mark.parametrize("name", sorted(parity.CHECKS))
def test_parity_on_card(gpu, name):
    assert parity.CHECKS[name]().startswith(name)


def test_tracking_chunk_matches_cpu(gpu):
    assert parity.check_scan_vs_cpu(8).startswith("scan_vs_cpu")
