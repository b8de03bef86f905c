"""The paged decode step replayed as a CUDA graph (models/decode_graph.py).

A paged engine whose bundle replays the step and one whose bundle runs the
eager step serve the same requests with churn: slots finishing and taking
new requests (tables pushed), rows growing across block boundaries, and a
second run after the engine's reset (new pools, so a second capture).
Tokens, every step's logits, lengths and pools, the MoE counts stashed for
each step and the kernels' launch counts must be equal, bit for bit; the
``model.decode.graph`` spans count one capture per key.

On the card (marked ``cuda``) the graph is a ``torch.cuda.CUDAGraph``.
On the CPU the same bookkeeping runs with a graph that reruns the
captured function at each replay, and the real runner runs eagerly.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import trace as T
from repro_torch.configs import reduced_config
from repro_torch.distributed.sharding import axis_rules, default_rules
from repro_torch.kernels import _launches as K
from repro_torch.kernels.decode_attention import paged_decode_attention
from repro_torch.kernels.moe_gmm import gmm
from repro_torch.models import decode_graph as DG
from repro_torch.models.registry import build_model
from repro_torch.serve import EngineConfig, ServeEngine, ServeRequest

ARCHS = ["dbrx-132b", "qwen3-4b", "mistral-large-123b"]
# (prompt length, max_new) over 3 slots with blocks of 8: rows cross block
# boundaries, finish at different steps and free their slots mid-run
BURST = [(5, 9), (13, 4), (8, 12), (3, 6), (17, 5), (9, 10), (6, 3)]
ENGINE = dict(slots=3, cache_len=64, pad_to=4, max_prefill_batch=2,
              paged=True, block_size=8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


class _Rerun:
    """A stand-in for a CUDA graph on the CPU: ``replay`` reruns the
    captured function and copies its outputs into the first run's."""

    def __init__(self, run):
        self.run = run
        self.outs = run()

    def replay(self):
        for have, new in zip(self.outs, self.run()):
            if have is not None:
                have.copy_(new)


class _CpuGraph(DG._Graph):
    def _capture(self, run):
        self.graph = _Rerun(run)
        return self.graph.outs


class CpuGraphs(DG.DecodeGraphs):
    DEVICE = "cpu"
    Graph = _CpuGraph


def _requests(cfg, seed):
    rng = np.random.default_rng(seed)
    return [ServeRequest(rid=i, prompt=rng.integers(
                0, cfg.vocab_size, n).astype(np.int32), max_new=m)
            for i, (n, m) in enumerate(BURST)]


def _recording(decode, steps):
    """``decode`` keeping each step's logits, lengths and pools (copies)
    and the lengths tensor it returned (the tensor itself, which the engine
    writes in place at its next admission)."""
    def call(params, cache, batch):
        logits, out = decode(params, cache, batch)
        steps.append(dict(logits=logits.clone(), lens=out["lens"].clone(),
                          k=out["k"].clone(), v=out["v"].clone(),
                          kept=out["lens"]))
        return logits, out
    return call


def _moe_counts(snap, engine):
    """The per-expert counts stashed under ``engine``'s decode steps."""
    steps = {s.i for s in snap.named("serve.step.enqueue")
             if s.engine == engine.trace_tag}
    entries = [m for m in snap.moe if m[3] in steps]
    return T.moe_counts(entries) if entries else None


def _serve(bundle, decode, params, device, runs=2):
    """Requests through a paged engine whose decode is ``decode``, twice
    (``run`` resets the engine): (engine, [tokens], steps, launches)."""
    steps = []
    engine = ServeEngine(
        dataclasses.replace(bundle, decode_paged=_recording(decode, steps)),
        params, EngineConfig(**ENGINE), device=device)
    before = gmm.launches, paged_decode_attention.launches
    tokens = [[r.out for r in engine.run(_requests(bundle.cfg, seed))]
              for seed in range(runs)]
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = (gmm.launches - before[0],
                paged_decode_attention.launches - before[1])
    return engine, tokens, steps, launches


def _graph_equals_eager(arch, device, dtype, runner):
    cfg = reduced_config(arch, dtype=dtype)
    bundle = build_model(cfg)
    params = bundle.init(0, device=device)
    graphs = runner(bundle.decode_paged.eager)
    with torch.no_grad():
        eng_g, tok_g, steps_g, launches_g = _serve(bundle, graphs, params,
                                                   device)
        eng_e, tok_e, steps_e, launches_e = _serve(
            bundle, bundle.decode_paged.eager, params, device)
    snap = T.TRACER.snapshot()
    assert tok_g == tok_e
    assert len(steps_g) == len(steps_e) > 0
    for g, e in zip(steps_g, steps_e):
        for name in ("logits", "lens", "k", "v"):
            assert torch.equal(g[name], e[name]), name
    # each step's lengths are a tensor of its own, never the graph's buffer
    assert len({g["kept"].data_ptr() for g in steps_g}) == len(steps_g)
    assert launches_g == launches_e
    if device.type == "cuda":
        assert launches_g[1] == len(steps_g) * cfg.n_layers
    counts_g, counts_e = _moe_counts(snap, eng_g), _moe_counts(snap, eng_e)
    if cfg.family == "moe":
        for a, b in zip(counts_g, counts_e):
            assert np.array_equal(a, b)
        assert len(counts_g[0]) == len(steps_g) * cfg.n_layers
    else:
        assert counts_g is None and counts_e is None
    spans = [s for s in snap.named("model.decode.graph")
             if s.engine == eng_g.trace_tag]
    assert len(spans) == len(steps_g)
    modes = [s.attrs[0] for s in spans]
    assert modes.count("capture") == 2 and graphs.captures == 2
    assert modes.count("replay") == len(spans) - 2
    assert modes[0] == "capture" and spans[-1].attrs[1] == 2
    assert len(graphs.graphs) == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_graph_bookkeeping_equals_the_eager_step(arch):
    """On the CPU, with a graph that reruns the captured function."""
    _graph_equals_eager(arch, torch.device("cpu"), "float32", CpuGraphs)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_replayed_step_equals_the_eager_step(arch, cuda_device):
    """On the card: the captured step, launched as one graph."""
    _graph_equals_eager(arch, cuda_device, "bfloat16", DG.DecodeGraphs)


def test_the_runner_runs_the_eager_step_off_the_card():
    """No card: every call eager, a span each, nothing captured."""
    cfg = reduced_config("dbrx-132b")
    bundle = build_model(cfg)
    params = bundle.init(0, device="cpu")
    engine = ServeEngine(bundle, params, EngineConfig(**ENGINE),
                         device="cpu")
    done = engine.run(_requests(cfg, 0))
    spans = [s for s in T.TRACER.snapshot().named("model.decode.graph")
             if s.engine == engine.trace_tag]
    assert len(spans) == engine.decode_steps
    assert {s.attrs for s in spans} == {("eager", 0)}
    assert bundle.decode_paged.captures == 0 and not bundle.decode_paged.graphs
    assert all(r.done for r in done)


@pytest.mark.parametrize("why", ["rules", "grad", "copied pools"])
def test_the_runner_stays_eager_where_it_cannot_capture(why):
    """Rules installed (a mesh), a parameter that takes a gradient, or
    pools without their spare blocks: the step runs eagerly."""
    cfg = reduced_config("qwen3-4b")
    bundle = build_model(cfg)
    params = bundle.init(0, device="cpu")
    graphs = CpuGraphs(bundle.decode_paged.eager)
    cache = bundle.make_paged_cache(3, 64, 24, 8, device="cpu")
    batch = {"tokens": torch.zeros((3, 1), dtype=torch.int32),
             "active": torch.tensor([True, False, True])}
    ctx = contextlib.nullcontext()
    if why == "rules":
        ctx = axis_rules(default_rules(), None)
    elif why == "grad":
        params["embed"].requires_grad_(True)
    else:
        cache = {k: v.clone() for k, v in cache.items()}
    with ctx:
        for _ in range(2):
            _, cache = graphs(params, cache, batch)
    assert graphs.captures == 0 and not graphs.graphs
    assert cache["lens"].tolist() == [2, 0, 2]


def test_launch_counts_of_a_capture_are_taken_back_and_replayed():
    """What the wrappers counted during a capture, taken back and then
    counted once a replay, by path."""
    def op():
        pass
    op.launches, op.launches_by_path = 0, {"a": 0, "b": 0}
    K.count_launch(op, "a")
    before = K.launch_counts()
    for path in ("a", "b", "b"):
        K.count_launch(op, path)
    counted = K.launches_since(before)
    assert counted == [(op, 3, {"a": 1, "b": 2}, {})]
    K.add_launches(counted, -1)
    assert (op.launches, op.launches_by_path) == (1, {"a": 1, "b": 0})
    K.add_launches(counted)
    K.add_launches(counted)
    assert (op.launches, op.launches_by_path) == (7, {"a": 3, "b": 4})
    assert K.launches_since(K.launch_counts()) == []
