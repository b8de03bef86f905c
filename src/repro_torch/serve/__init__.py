"""Continuous-batching inference serving (dense slots).

* :class:`~repro_torch.serve.engine.ServeEngine` — slot-cache continuous
  batching over a ModelBundle's slotted prefill/decode path.
* :func:`~repro_torch.serve.engine.greedy_reference` — the one-request
  scalar oracle.
* :mod:`repro_torch.serve.buckets` — prefill admission buckets (a copy of
  the reference's numpy module).
"""
from repro_torch.serve.buckets import PrefillBucket, build_buckets
from repro_torch.serve.engine import (
    EngineConfig,
    ServeEngine,
    ServeRequest,
    greedy_reference,
)

__all__ = [
    "EngineConfig",
    "PrefillBucket",
    "ServeEngine",
    "ServeRequest",
    "build_buckets",
    "greedy_reference",
]
