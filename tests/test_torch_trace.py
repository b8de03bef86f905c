"""The port's tracer (repro_torch/trace.py) on a small paged MoE engine.

The engine records spans at its own boundaries and request events; the
MoE block keeps each call's per-expert pair counts.  These tests hold the
span tree, the events' order, the ring's bound, the tracer's absence of
effect on the tokens served, and the drop count read from the counts
against a recount of the dispatch's own ``keep``, on the CPU; the last
one runs the block on the card under the sync debug mode.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch import trace as T
from repro_torch.configs import reduced_config
from repro_torch.models import moe as M
from repro_torch.models.registry import build_model
from repro_torch.serve import EngineConfig, ServeEngine, ServeRequest

# (prompt length, max_new) over 3 slots: admissions mid-run, buckets of 3
BURST = [(4, 6), (11, 3), (7, 9), (11, 5), (5, 5), (9, 8), (13, 4), (4, 7)]
ENGINE = dict(slots=3, cache_len=48, pad_to=4, max_prefill_batch=3,
              paged=True, block_size=8)
PARENT = {
    "serve.expire": "serve.tick", "serve.admit": "serve.tick",
    "serve.step": "serve.tick", "serve.prefill": "serve.admit",
    "serve.prefill.enqueue": "serve.prefill",
    "serve.prefill.splice": "serve.prefill",
    "serve.prefill.sync": "serve.prefill",
    "serve.step.grow": "serve.step", "serve.step.tables": "serve.step",
    "serve.step.enqueue": "serve.step", "serve.step.sync": "serve.step",
    "serve.step.emit": "serve.step",
    "model.decode.graph": "serve.step.enqueue",
    # one a decode step and one a prefill call (models/glue.py)
    "model.glue": ("serve.step.enqueue", "serve.prefill.enqueue"),
}
STEP = ["serve.step.grow", "serve.step.tables", "serve.step.enqueue",
        "serve.step.sync", "serve.step.emit"]
REQUEST = ["request.submit", "request.admit", "request.first_token",
           "request.done"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg = reduced_config("dbrx-132b")
    bundle = build_model(cfg)
    return cfg, bundle, bundle.init(0, device="cpu")


def _requests(cfg):
    rng = np.random.default_rng(0)
    return [ServeRequest(rid=i, prompt=rng.integers(
                0, cfg.vocab_size, pl).astype(np.int32), max_new=mn)
            for i, (pl, mn) in enumerate(BURST)]


def _serve(model):
    """(engine, requests served, snapshot) of one run of BURST."""
    cfg, bundle, params = model
    eng = ServeEngine(bundle, params, EngineConfig(**ENGINE), device="cpu")
    done = eng.run(_requests(cfg))
    return eng, done, T.TRACER.snapshot()


def _mine(snap, eng):
    return [s for s in snap.spans if s.engine == eng.trace_tag]


def test_every_span_lies_inside_its_parent(model):
    eng, done, snap = _serve(model)
    spans = _mine(snap, eng)
    assert {s.name for s in spans} == set(PARENT) | {"serve.tick"}
    ticks = [s for s in spans if s.name == "serve.tick"]
    assert len(ticks) == eng.decode_steps   # every tick of run() decoded
    for s in spans:
        if s.name == "serve.tick":
            assert s.parent == -1
            continue
        p = snap.by_i[s.parent]
        parent = PARENT[s.name]
        assert p.name in (parent if isinstance(parent, tuple) else
                          (parent,)), s
        assert p.t0 <= s.t0 <= s.t1 <= p.t1, (s, p)
        assert snap.epoch_offset(s) == snap.epoch_offset(p)
    for s in spans:
        if s.name == "serve.step":
            assert [c.name for c in snap.children(s)] == STEP
            assert s.attrs == (snap.by_i[s.parent].attrs[2],)
        if s.name == "serve.prefill":
            rows, length, prompt, rids = s.attrs
            assert rows == len(rids) and length % ENGINE["pad_to"] == 0
            assert prompt == sum(BURST[r][0] for r in rids)
    produced = sum(s.attrs[2] for s in ticks)
    assert produced == sum(len(r.out) for r in done) - len(done)
    assert sum(s.attrs[1] for s in ticks) == len(BURST)
    # the wall clock read beside each tick's start
    now = time.time_ns()
    assert all(0 < now - s.attrs[0] < 600 * 10 ** 9 for s in ticks)


def test_request_events_come_in_order(model):
    eng, done, snap = _serve(model)
    times = {}
    for name in REQUEST:
        for e in snap.named(name):
            if e.engine == eng.trace_tag:
                assert (name, e.rid) not in times
                times[name, e.rid] = e.t
    for r in done:
        ts = [times[name, r.rid] for name in REQUEST]
        assert ts == sorted(ts), r.rid
    assert all(e.note == "" for e in snap.named("request.done")
               if e.engine == eng.trace_tag)


def test_the_ring_wraps_at_its_capacity():
    ticks = iter(range(10 ** 6))
    tr = T.Tracer(capacity=16, moe_capacity=4, clock=lambda: next(ticks),
                  wall=lambda: 10 ** 18)
    for k in range(10):
        tr.open_tick(1)
        tr.open("serve.step", 1)
        tr.moe(torch.tensor([k, 0]), 8, 2)
        tr.close()
        tr.event("request.submit", 1, k)
        tr.close_tick((0, 0, 0, 0))
    assert len(tr._ring) == 16 and len(tr._moe_counts) == 4 and tr.n == 30
    snap = tr.snapshot()
    records = sorted([s.i for s in snap.spans] + [e.i for e in snap.events])
    assert records == list(range(14, 30))
    assert [e.rid for e in snap.events] == [4, 5, 6, 7, 8, 9]
    assert [int(m[0][0]) for m in snap.moe] == [6, 7, 8, 9]
    assert all(m[3] == snap.named("serve.step")[-4 + k].i
               for k, m in enumerate(snap.moe))
    for s in snap.named("serve.step"):
        tick = snap.by_i[s.parent]
        assert tick.name == "serve.tick" and tick.t0 < s.t0 < s.t1 < tick.t1
        assert snap.epoch_offset(s) == 10 ** 18 - tick.t0
    assert tr.snapshot() is snap


def test_disabled_tracer_records_nothing_and_serves_the_same(model):
    eng_on, on, _ = _serve(model)
    T.TRACER.disable()
    try:
        n, n_moe = T.TRACER.n, T.TRACER.n_moe
        eng_off, off, _ = _serve(model)
        assert (T.TRACER.n, T.TRACER.n_moe) == (n, n_moe)
    finally:
        T.TRACER.enable()
    assert [r.out for r in on] == [r.out for r in off]
    assert eng_on.stats() == eng_off.stats()


def _moe_case(cfg, device, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    p = {k: v.to(device) for k, v in M.init_moe(gen, cfg, dtype).items()}
    x = torch.randn(2, 32, cfg.d_model, generator=gen).to(device, dtype)
    return p, x


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_drops_read_from_the_counts_equal_the_dispatch_drops(
        model, capacity_factor):
    cfg = dataclasses.replace(model[0], capacity_factor=capacity_factor)
    p, x = _moe_case(cfg, "cpu", torch.float32)
    n = T.TRACER.n_moe
    M._moe_block(p, x, cfg)
    assert T.TRACER.n_moe == n + 1
    counts, caps, tokens = T.moe_counts(T.TRACER.snapshot().moe[-1:])
    t = x.shape[0] * x.shape[1]
    assert tokens.tolist() == [t]
    assert caps.tolist() == [M.expert_capacity(t, cfg)]
    dropped = int(np.clip(counts - caps[:, None], 0, None).sum())
    _, _, experts = M.route(p, x.reshape(t, -1), cfg)
    _, _, _, keep = M._dispatch_local(experts.reshape(-1), cfg.n_experts,
                                      int(caps[0]))
    assert dropped == int((~keep).sum())
    assert int(counts.sum()) == t * cfg.experts_per_token
    if capacity_factor < 1:
        assert dropped > 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_the_counts_stash_does_not_sync_the_device(model, cuda_device):
    """The block with the tracer on, under the sync debug mode that raises
    on any wait of the host for the device (the first call builds the
    kernels, outside it)."""
    cfg = dataclasses.replace(model[0], capacity_factor=0.5)
    p, x = _moe_case(cfg, cuda_device, torch.bfloat16)
    M._moe_block(p, x, cfg)
    torch.cuda.synchronize()
    n = T.TRACER.n_moe
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, _ = M._moe_block(p, x, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert T.TRACER.n_moe == n + 1
    counts, caps, _ = T.moe_counts(T.TRACER.snapshot().moe[-1:])
    assert np.clip(counts - caps[:, None], 0, None).sum() > 0
    assert torch.isfinite(y.float()).all()
