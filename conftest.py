"""Repository-wide pytest settings: the marker of tests that need a card.

Tests marked ``cuda`` run the port's hand-written kernels; they skip, with
a reason, on a machine without an NVIDIA GPU (the ``cuda_device`` fixture
in tests/test_torch_cuda.py decides, at run time).  Run them on the card
with ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skipped without one)")
