"""pytest settings of the benchmark's own tests (``python3 -m pytest
kmerbench/tests``): the repo's root on the path, and the ``card`` marker
for tests that need a CUDA card. Whether there is a card is decided inside
the ``card`` fixture, never while a module is imported."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the card with `python3 -m pytest kmerbench/tests -m card`")
    return torch.device("cuda")
