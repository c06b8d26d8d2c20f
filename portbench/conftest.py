"""pytest settings of the benchmark's own tests (``python -m pytest
portbench/tests``): the ``chip`` marker for tests that need a CUDA card,
which skip inside a fixture where there is none; ``portbench`` importable
from the checkout's root."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda")
