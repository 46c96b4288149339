"""Tests of the benchmark's own code (not collected by the repository's
tests/ run): `python3 -m pytest mvebench/tests -q`. Those that need the
card carry the `chip` marker and skip without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    """Skips the test where no CUDA device is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    return torch.device("cuda")
