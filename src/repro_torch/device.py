"""Device policy shared by every entry point of the port."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card: an entry point never drifts onto the CPU
    silently.  Pass ``device="cpu"`` to run the plain PyTorch versions.
    A CUDA device comes back with its index (``cuda`` -> ``cuda:0``), so
    it compares equal to the device of the tensors made on it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string (``"bfloat16"``, ``"float32"``) -> torch dtype."""
    dt: Optional[torch.dtype] = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt
