"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
checkout's root (on the card, ``-m cuda`` runs the control's test too).
The port is imported from ``src/``, as ``portbench/run.py`` does."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skipped without one)")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
