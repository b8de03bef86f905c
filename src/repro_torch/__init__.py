"""PyTorch + CUDA port of ``repro`` for one NVIDIA H100.

Mirrors ``repro``'s module paths (``repro_torch/models/attention.py`` is
the counterpart of ``repro/models/attention.py``) and imports nothing of
``repro`` or JAX: where the port needs a numpy-only helper of the
reference it keeps its own copy.  Hand-written Hopper kernels live in
``csrc/`` and are built at first use (``repro_torch/_build.py``).

Entry points run on CUDA unless the caller passes ``device="cpu"``; with
no ``device`` and no card they raise (:func:`resolve_device`).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
