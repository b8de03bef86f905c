"""Mamba-2 SSD scan: chunked plain version, naive recurrence oracle and the
hand-written kernel's wrapper."""
from repro_torch.kernels.ssd.ops import ssd_scan
from repro_torch.kernels.ssd.ref import ssd_chunked, ssd_ref

__all__ = ["ssd_chunked", "ssd_ref", "ssd_scan"]
