"""Roofline terms of one step on one rank, counted from its local ops.

Counterpart of ``repro/launch/roofline.py``.  The reference compiles each
cell and walks the partitioned HLO; the port has no HLO, so a
``TorchDispatchMode`` (:class:`LocalOpCounter`) sees the ops one rank
runs, under DTensor, in eager order:

* an op on DTensors is handed back to DTensor (the mode returns
  ``NotImplemented``), which runs it as local ops and collectives that
  come back to the mode: each local op is counted once, per device (a
  ``FlopCounterMode`` entered outside DTensor counts the global op as
  well);
* FLOPs: the matmul family (``torch.utils.flop_counter``'s formulas), and
  each kernel call by the formula of its bound (``PERF.md`` §6; the
  wrappers report it from their fake-tensor branch);
* HBM bytes: every eager op's inputs plus outputs (eager PyTorch fuses
  nothing, so this is what it moves), collectives' too, views and
  metadata ops excepted, and each kernel call's bound bytes; an expanded
  dim counts once; ``bytes_dev_min`` keeps only the
  traffic no fusion avoids (matmuls, kernels, gathers and scatters, copies
  and collectives), as the reference's ideal-fusion lower bound;
* collective bytes per kind: the operand bytes of each
  ``_c10d_functional`` collective;
* the live bytes of the rank at their peak (every storage from its first
  op to its release) and the largest buffers.

DTensor's sharding propagation runs ops of its own on global-shape fake
arguments to learn an op's output; those are bookkeeping, not work of the
rank, and are not counted.

The terms are taken with the card's constants (:data:`H100_SXM`) in the
reference's three-term formula (``TPURooflineBackend.roofline_terms``):
compute over the peak, bytes over HBM's rate, collective bytes over one
link's.  They state what a step on the mesh would need, not a time any
card took.
"""
from __future__ import annotations

import dataclasses
import heapq
import os
import sys
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
# registers _c10d_functional's Python-defined ops (_wrap_tensor_autograd)
import torch.distributed._functional_collectives  # noqa: F401
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.core.hw_model import RooflineTerms, roofline
from repro_torch.kernels._launches import recording_fake_calls

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops_bf16: float     # FLOP/s per device, dense
    hbm_bw: float              # B/s per device
    link_bw: float             # B/s per device, one direction
    source: str


# NVIDIA H100 SXM5 datasheet: 989.4 TFLOP/s dense bf16 (1,979 with
# sparsity), 3.35 TB/s HBM3, NVLink 900 GB/s total (450 GB/s a direction)
H100_SXM = Hardware("h100_sxm", 989.4e12, 3.35e12, 450e9,
                    "NVIDIA H100 SXM5 datasheet")
# the reference's constants (repro/core/hw_model.py): TPU v5e, one ICI link
TPU_V5E = Hardware("tpu_v5e", 197e12, 819e9, 50e9,
                   "repro/core/hw_model.py (TPU v5e)")


def roofline_terms(flops: float, bytes_hbm: float, bytes_collective: float,
                   chips: int, hw: Hardware = H100_SXM) -> RooflineTerms:
    """The reference's three-term roofline (pod totals in, per-device
    times out) with ``hw``'s constants."""
    return roofline(flops, bytes_hbm, bytes_collective, chips,
                    hw.peak_flops_bf16, hw.hbm_bw, hw.link_bw)


# ---------------------------------------------------------------------------
# The local-op counter
# ---------------------------------------------------------------------------

def _ops(namespace, *names) -> set:
    """The named op packets of ``namespace`` that this PyTorch has."""
    ns = getattr(torch.ops, namespace)
    return {getattr(ns, n) for n in names if hasattr(ns, n)}


def _coll(kind: str, *names) -> dict:
    return dict.fromkeys(_ops("_c10d_functional", *names), kind)


_COLL_KIND = {
    **_coll("all-gather", "all_gather_into_tensor",
            "all_gather_into_tensor_coalesced"),
    **_coll("reduce-scatter", "reduce_scatter_tensor",
            "reduce_scatter_tensor_coalesced"),
    **_coll("all-reduce", "all_reduce", "all_reduce_coalesced"),
    **_coll("all-to-all", "all_to_all_single"),
    **_coll("collective-permute", "broadcast"),
}
# ops that move no data: views, metadata, waits, a collective's autograd
# wrapper
_NO_BYTES = _ops(
    "aten", "view", "_unsafe_view", "reshape", "expand", "permute",
    "transpose", "t", "squeeze", "unsqueeze", "slice", "select", "split",
    "split_with_sizes", "chunk", "unbind", "narrow", "as_strided", "alias",
    "detach", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "lift_fresh", "sym_size", "sym_stride",
    "sym_numel", "is_same_size", "_local_scalar_dense", "set_") | _ops(
    "_c10d_functional", "wait_tensor", "_wrap_tensor_autograd")
_PROPAGATOR = os.path.join("distributed", "tensor", "_sharding_prop.py")
# traffic an ideal fusion cannot avoid (the reference's lower bound)
_MIN_BYTES = _ops(
    "aten", "mm", "bmm", "addmm", "baddbmm", "convolution", "gather",
    "scatter", "scatter_add", "index", "index_put", "index_put_",
    "index_select", "embedding", "copy_", "clone", "sort", "cat", "stack")


def _in_sharding_propagation() -> bool:
    """Whether the op at hand is DTensor's shape bookkeeping (run from its
    sharding propagator on global-shape fake arguments)."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_PROPAGATOR):
            return True
        f = f.f_back
    return False


def _tensors(tree: Any) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            out.extend(_tensors(t))
    elif isinstance(tree, dict):
        for t in tree.values():
            out.extend(_tensors(t))
    return out


def _nbytes(ts: List[torch.Tensor]) -> int:
    """Bytes the tensors hold: an expanded dim (stride 0) counts once."""
    total = 0
    for t in ts:
        n = t.element_size()
        for size, stride in zip(t.shape, t.stride()):
            if stride:
                n *= size
        total += n
    return total


@dataclasses.dataclass
class LocalCounts:
    flops: float = 0.0
    bytes_hbm: float = 0.0
    bytes_hbm_min: float = 0.0
    bytes_collective: float = 0.0
    coll_breakdown: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0.0))
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    live_bytes: int = 0
    peak_bytes: int = 0
    n_ops: int = 0
    top_buffers: List[Tuple[float, str]] = dataclasses.field(
        default_factory=list)
    top_dots: List[Tuple[float, str]] = dataclasses.field(
        default_factory=list)
    top_colls: List[Tuple[float, str]] = dataclasses.field(
        default_factory=list)


class LocalOpCounter(TorchDispatchMode):
    """Counts one rank's local ops (see the module's docstring).  Enter it
    inside ``FakeTensorMode``; :meth:`hold` the step's arguments first so
    their storages count as live from the start."""

    def __init__(self, top_k: int = 8):
        super().__init__()
        self.c = LocalCounts()
        self._live: Dict[int, int] = {}
        self._top_k = top_k
        self._fake_calls = recording_fake_calls(self._kernel)

    def __enter__(self):
        self._fake_calls.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        self._fake_calls.__exit__(*exc)
        return super().__exit__(*exc)

    # ---- live storages ----------------------------------------------------
    def hold(self, tree: Any) -> None:
        """Count the storages of ``tree``'s tensors (DTensors: their local
        shards) as live."""
        from torch.distributed.tensor import DTensor
        for t in _tensors(tree):
            self._track(t.to_local() if isinstance(t, DTensor) else t)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.c.live_bytes += n
        self.c.peak_bytes = max(self.c.peak_bytes, self.c.live_bytes)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.c.live_bytes -= self._live.pop(key, 0)

    # ---- records ----------------------------------------------------------
    def _push(self, heap: list, value: float, desc: str) -> None:
        item = (value, desc)
        if len(heap) < self._top_k:
            heapq.heappush(heap, item)
        elif value > heap[0][0]:
            heapq.heapreplace(heap, item)

    def _kernel(self, name: str, flops: float, nbytes: float) -> None:
        k = self.c.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                             "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.c.flops += flops
        self.c.bytes_hbm += nbytes
        self.c.bytes_hbm_min += nbytes
        self._push(self.c.top_dots, flops, f"kernel {name}")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # DTensor runs it as local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim" or _in_sharding_propagation():
            return out      # metadata (prim.device ...) or bookkeeping
        packet = func._overloadpacket
        self.c.n_ops += 1
        ins = _tensors(args) + _tensors(kwargs)
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        kind = _COLL_KIND.get(packet)
        if kind is not None:
            b = _nbytes(ins)
            self.c.coll_breakdown[kind] += b
            self.c.bytes_collective += b
            self._push(self.c.top_colls, b,
                       f"{kind} {[tuple(t.shape) for t in ins]}")
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            self.c.flops += f
            self._push(self.c.top_dots, f,
                       f"{packet.__name__} "
                       f"{[tuple(t.shape) for t in ins]}")
        if packet not in _NO_BYTES:
            b = _nbytes(ins) + _nbytes(outs)
            self.c.bytes_hbm += b
            if packet in _MIN_BYTES or kind is not None:
                self.c.bytes_hbm_min += b
            if outs:
                self._push(self.c.top_buffers, b,
                           f"{packet.__name__} -> "
                           f"{[tuple(t.shape) for t in outs]} "
                           f"{outs[0].dtype}")
        return out

    def sorted(self, heap: list) -> List[Tuple[float, str]]:
        return sorted(heap, key=lambda t: -t[0])


@dataclasses.dataclass
class CellReport:
    arch: str
    shape: str
    mesh: str
    kind: str
    ok: bool
    error: str = ""
    compile_s: float = 0.0      # the port: seconds the fake step took
    # memory (per device)
    arg_bytes: float = 0.0
    out_bytes: float = 0.0
    temp_bytes: float = 0.0
    peak_bytes: float = 0.0
    # roofline (per device per step)
    flops_dev: float = 0.0
    bytes_dev: float = 0.0
    bytes_dev_min: float = 0.0   # ideal-fusion lower bound
    coll_dev: float = 0.0
    coll_breakdown: Optional[Dict[str, float]] = None
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = ""
    model_flops: float = 0.0
    useful_fraction: float = 0.0   # MODEL_FLOPS / (flops_dev * chips)
    top_buffers: Optional[List[str]] = None
    note: str = ""

    def to_dict(self):
        return dataclasses.asdict(self)
