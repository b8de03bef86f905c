"""Hand-written Hopper kernels of the port.

Each kernel directory holds ``ref.py`` (the plain PyTorch version, used on
the CPU and as the kernel's oracle on the card) and ``ops.py`` (the
wrapper: checks, launch, launch count).  CUDA sources live in
``repro_torch/csrc`` and are built by ``repro_torch/_build.py``.
"""
