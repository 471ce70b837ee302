"""The benchmark's own tests: ``python -m pytest bench_port/tests -q``
from the root of the repo. On the CPU they run the harness at tiny sizes
(the port's CPU paths); tests marked ``cuda`` need a card and skip
without one (``-m cuda`` on the chip)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
