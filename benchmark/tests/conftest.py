"""The benchmark's own tests (``python -m pytest benchmark/tests``): the
CPU tests run anywhere; those marked ``card`` run the benchmark on a CUDA
card and skip without one."""

import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
for p in (str(BENCH_DIR.parent), str(BENCH_DIR), str(BENCH_DIR / "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: runs the benchmark on a CUDA card (skips without)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the card")
    return torch.device("cuda")
