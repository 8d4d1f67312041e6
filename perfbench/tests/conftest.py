"""The benchmark's own tests: `python -m pytest perfbench/tests -q` (the CPU
ones; the `cuda` ones skip without a card and run on one)."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (runs the program's kernels)")


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
