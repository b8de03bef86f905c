"""The paged decode step, replayed as one CUDA graph.

The LM bundle's ``decode_paged`` is a :class:`DecodeGraphs` around the
eager step (:func:`~repro_torch.models.transformer.lm_decode_step_paged`).
On the card an eager step of dbrx-132b cut to 8 layers is about 1,100
kernel launches, which the host issues more slowly than the device runs
them (``PERF.md``); a replay is one launch.  The hand-written kernels are
the graph's nodes as they are: their wrappers launch on the current
stream, which a capture records.

Where: on CUDA, with no mesh or rules installed, no DTensor, fake tensor
or parameter that takes a gradient, and pools made by
``init_paged_cache``, whose spare blocks give the step's pool write fixed
shapes and no read back to the host
(:func:`~repro_torch.models.attention.paged_write_index`).  Anywhere else
the eager step runs: the CPU, a mesh (the EP path's all-to-alls), gloo.

Key: the pools' and every parameter's data pointers, the pools' shape, the
batch size, the block tables' width and the inputs' dtypes.  The first call
of a key runs the eager step and returns its result, then captures the
step (nothing runs in a capture: the pools are as the eager step left
them).  Each later call of the key copies ``tokens``, ``active``,
``lens`` and ``tables`` into the graph's own buffers and replays it.  The
last :data:`KEEP` keys used keep their graphs (a router's replicas on one
card each have their own pools).

Outputs: the logits are the graph's output buffer, which the key's next
replay overwrites (the engine reads them first); ``lens`` is a new tensor
every call; ``k``, ``v`` and ``tables`` are the caller's.

What a replay calls no Python for, the runner does: it counts the kernel
launches the wrappers counted at capture (``kernels/_launches.py``), and
with the tracer on, stashes the MoE blocks' per-expert counts, which the
captured step gathers into one (layers, experts) buffer, copied once a
replay (``trace.py``).  Each call records a ``model.decode.graph`` span,
attrs ``(mode, captures so far)``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.distributed.sharding import (
    current_mesh,
    current_rules,
    is_dtensor,
)
from repro_torch.kernels._launches import (
    add_launches,
    is_fake,
    launch_counts,
    launches_since,
)
from repro_torch.models.attention import spare_pools
from repro_torch.trace import TRACER

KEEP = 4


def _leaves(tree, out: List[torch.Tensor]) -> List[torch.Tensor]:
    """``tree``'s leaves appended to ``out`` (dicts and lists are
    containers), which is returned."""
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    else:
        out.append(tree)
    return out


class _Graph:
    """One captured step, its input buffers and its outputs."""

    def __init__(self, step: Callable, params, cache: Dict[str, Any],
                 batch: Dict[str, torch.Tensor]):
        self.tokens = batch["tokens"].clone()
        self.active = batch["active"].clone()
        self.lens = cache["lens"].clone()
        self.tables = cache["tables"].clone()
        inputs = dict(cache, lens=self.lens, tables=self.tables)

        def run():
            with TRACER.holding_moe() as moe:
                logits, out = step(params, inputs, {"tokens": self.tokens,
                                                    "active": self.active})
            self.moe = [m[1:] for m in moe]
            return (logits, out["lens"],
                    torch.stack([m[0] for m in moe]) if moe else None)
        before = launch_counts()
        self.logits, self.lens_out, self.counts = self._capture(run)
        # the wrappers counted as they were called; nothing launched
        self.launches = launches_since(before)
        add_launches(self.launches, -1)

    def _capture(self, run: Callable) -> tuple:
        """``run()``'s outputs, its work captured into ``self.graph``."""
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            return run()

    def replay(self, cache: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        self.tokens.copy_(batch["tokens"])
        self.active.copy_(batch["active"])
        self.lens.copy_(cache["lens"])
        self.tables.copy_(cache["tables"])
        self.graph.replay()
        add_launches(self.launches)
        if self.counts is not None and TRACER.on:
            counts = self.counts.clone()
            for i, (cap, tokens) in enumerate(self.moe):
                TRACER.moe(counts[i], cap, tokens)
        return self.logits, {"k": cache["k"], "v": cache["v"],
                             "tables": cache["tables"],
                             "lens": self.lens_out.clone()}


class DecodeGraphs:
    """``decode_paged(params, cache, batch)``: ``eager`` (the same call)
    replayed as a CUDA graph wherever it can be (the module's docstring).
    ``captures`` counts the graphs captured.  ``DEVICE`` and ``Graph``
    let a test run the bookkeeping on the CPU with a graph of its own."""

    DEVICE = "cuda"
    Graph = _Graph

    def __init__(self, eager: Callable):
        self.eager = eager
        self.graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()
        self.captures = 0

    def __call__(self, params, cache: Dict[str, Any],
                 batch: Dict[str, torch.Tensor]):
        t0 = TRACER.now() if TRACER.on else 0
        key = self._key(params, cache, batch)
        graph = None if key is None else self.graphs.get(key)
        if graph is not None:
            self.graphs.move_to_end(key)
            out, mode = graph.replay(cache, batch), "replay"
        else:
            out, mode = self.eager(params, cache, batch), "eager"
            if key is not None:
                self.graphs[key] = self.Graph(self.eager, params, cache,
                                              batch)
                self.captures += 1
                mode = "capture"
                if len(self.graphs) > KEEP:
                    self.graphs.popitem(last=False)
        if TRACER.on:
            TRACER.record("model.decode.graph", t0, (mode, self.captures))
        return out

    def _key(self, params, cache: Dict[str, Any],
             batch: Dict[str, torch.Tensor]) -> Optional[tuple]:
        """The graph's key, or None where the step runs eagerly."""
        k, v, tokens = cache["k"], cache["v"], batch["tokens"]
        if (k.device.type != self.DEVICE or is_fake(k)
                or current_mesh() is not None or current_rules() is not None
                or k.is_cuda and torch.cuda.is_current_stream_capturing()):
            return None
        if spare_pools(cache)[2] * k.shape[2] < tokens.shape[0]:
            return None     # the write would select its rows on the host
        leaves = _leaves(params, [])
        grad = torch.is_grad_enabled()
        for t in leaves:
            if (type(t) is not torch.Tensor and is_dtensor(t)
                    or grad and t.requires_grad):
                return None
        return (k.data_ptr(), v.data_ptr(), tuple(k.shape),
                tuple(tokens.shape), cache["tables"].shape[1], tokens.dtype,
                batch["active"].dtype, tuple(t.data_ptr() for t in leaves))
