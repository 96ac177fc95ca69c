"""CPU tests of the port's benchmark: python -m pytest portbench/tests.

Tests that need a CUDA card carry the `cuda` marker and decide inside a
fixture whether there is one."""

import os

import pytest

# a few threads a process: the multi-rank tests start four of them
os.environ.setdefault("OMP_NUM_THREADS", "2")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
