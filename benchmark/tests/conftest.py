"""CPU tests of the benchmark: the harness at a tiny size against the port's
plain kernel versions.  Card-only tests carry the ``chip`` marker and skip
themselves where no CUDA device is present; run them on the card with

    python3 -m pytest benchmark/tests -q -m chip -p no:cacheprovider
"""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

import torch  # noqa: E402

torch.set_num_threads(2)

from harness import core  # noqa: E402


def tiny(config: dict, traffic: dict) -> None:
    """Shrink a cell's configuration and mix in place to a CPU test's size:
    its driver's own ``tiny``."""
    core.driver_for(traffic).tiny(config, traffic)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device (runs on the card only)")


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided in the test, never at
    import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")
