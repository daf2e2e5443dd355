"""The benchmark's own tests: ``python -m pytest benchmark/tests`` (the
CPU ones at tiny sizes); the card's with ``-m cuda`` on a machine with
one."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    """Skips the test where torch sees no CUDA device."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; torch.cuda.is_available() is "
                    "False here")


@pytest.fixture
def tiny_root(tmp_path):
    from portbench_tiny import make_tiny_root
    return make_tiny_root(tmp_path / "tree")
