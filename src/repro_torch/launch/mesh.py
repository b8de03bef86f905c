"""The accelerators a search may spread its training over.

Counterpart of ``repro/launch/mesh.py: local_search_devices``; the rest of
that module (the TPU production mesh and its sharding rules) waits for the
port's pod tooling.
"""
from __future__ import annotations

from typing import List, Optional

import torch


def local_search_devices(max_devices: Optional[int] = None
                         ) -> List[torch.device]:
    """The CUDA devices of this host, at most ``max_devices`` of them: one
    scheduler worker group per entry (DESIGN.md §11).  Empty without a
    card."""
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return devs[:max_devices] if max_devices else devs
