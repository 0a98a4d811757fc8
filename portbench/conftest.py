"""Tests of the benchmark itself (run with `python -m pytest portbench
-q`).  Tests marked `card` need a CUDA card; each decides inside its
fixture, never at import, and skips here with the reason."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: this sandbox has none")
    return torch.cuda.device_count()
