"""Continuous-batching inference serving: dense slots or a paged KV cache,
one engine or replicas behind a router.

* :class:`~repro_torch.serve.engine.ServeEngine` — slot-cache continuous
  batching over a ModelBundle's slotted prefill/decode path, or over a
  block pool with ``EngineConfig(paged=True)``.
* :func:`~repro_torch.serve.engine.greedy_reference` — the one-request
  scalar oracle.
* :class:`~repro_torch.serve.router.ReplicaRouter` — N engine replicas
  behind one submit/run/drain API: health-checked dispatch, failover, load
  shedding, hedged requests.
* :mod:`repro_torch.serve.loadgen` — open-loop Poisson / heavy-tail /
  burst / long-tail-prompt workloads and latency stats.
* :mod:`repro_torch.serve.paged` — :class:`BlockPool`, the block allocator
  behind the paged engine.
* :mod:`repro_torch.serve.buckets` — prefill admission buckets.
* :func:`~repro_torch.serve.winner.compile_winner` — genome front-end:
  train -> compile -> :class:`ServableWinner`;
  :func:`~repro_torch.serve.winner.replicate_winner` adds replicated
  dispatch (:class:`ReplicatedWinner`).

``loadgen``, ``paged`` and ``buckets`` are copies of the reference's numpy
modules.
"""
from repro_torch.serve.buckets import PrefillBucket, build_buckets
from repro_torch.serve.engine import (
    EngineConfig,
    ServeEngine,
    ServeRequest,
    greedy_reference,
)
from repro_torch.serve.loadgen import (
    gamma_workload,
    latency_stats,
    longtail_workload,
    onoff_workload,
    poisson_workload,
)
from repro_torch.serve.paged import BlockPool, blocks_for
from repro_torch.serve.router import ReplicaRouter, RouterConfig
from repro_torch.serve.winner import (
    ReplicatedWinner,
    ServableWinner,
    compile_winner,
    replicate_winner,
)

__all__ = [
    "BlockPool",
    "EngineConfig",
    "PrefillBucket",
    "ReplicaRouter",
    "ReplicatedWinner",
    "RouterConfig",
    "ServableWinner",
    "ServeEngine",
    "ServeRequest",
    "blocks_for",
    "build_buckets",
    "compile_winner",
    "gamma_workload",
    "greedy_reference",
    "latency_stats",
    "longtail_workload",
    "onoff_workload",
    "poisson_workload",
    "replicate_winner",
]
