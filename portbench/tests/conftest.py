"""The benchmark's own tests (run by hand: `python -m pytest portbench/tests`).
Tests marked `card` need a CUDA device and skip without one; whether there
is one is decided inside the fixture, never while a module is imported."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture(autouse=True)
def _card(request):
    if request.node.get_closest_marker("card"):
        import torch
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device (run on the card)")
