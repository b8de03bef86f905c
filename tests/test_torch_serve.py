"""Port serving engine on the CPU: greedy parity with its own scalar
oracle and with the reference engine on the same weights, the in-place
prefill splice, the launcher, and the no-card device policy."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.models.registry import build_model as jax_build_model
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import ServeRequest as JaxServeRequest
from repro_torch.launch import serve as launch_serve
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import init_lm
from repro_torch.serve import (
    EngineConfig,
    ReplicaRouter,
    ServeEngine,
    ServeRequest,
    greedy_reference,
)
from repro_torch.weights import params_from_jax
from torch_parity import (  # noqa: F401 (one_thread: a fixture)
    SERVED_ARCHS,
    configs,
    one_thread,
    params,
)

CACHE_LEN = 48
BURST = [(4, 6), (11, 3), (7, 9), (16, 5), (5, 5), (9, 8), (13, 4), (6, 7)]


def _port(arch="qwen2-0.5b"):
    jcfg, tcfg = configs(arch)
    jp, tp = params(jcfg)
    return jcfg, tcfg, jp, build_model(tcfg), tp


def _requests(cfg, lens_out, cls=ServeRequest, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, cfg.vocab_size, pl).astype(
                np.int32), max_new=mn)
            for i, (pl, mn) in enumerate(lens_out)]


def _refs(bundle, params_, reqs):
    return {r.rid: greedy_reference(bundle, params_, r.prompt, r.max_new,
                                    CACHE_LEN, device="cpu") for r in reqs}


@pytest.mark.parametrize("arch", SERVED_ARCHS)
def test_engine_matches_own_oracle_and_reference_engine(arch):
    """Mixed burst through 4 slots (slot reuse, padded buckets): every
    request's tokens equal the port's scalar oracle and the reference
    engine's on the same weights."""
    jcfg, tcfg, jp, bundle, tp = _port(arch)
    reqs = _requests(tcfg, BURST)
    refs = _refs(bundle, tp, reqs)
    ecfg = dict(slots=4, cache_len=CACHE_LEN, pad_to=8, max_prefill_batch=4)
    done = ServeEngine(bundle, tp, EngineConfig(**ecfg), device="cpu").run(
        reqs)
    jax_done = JaxServeEngine(jax_build_model(jcfg), jp,
                              JaxEngineConfig(**ecfg)).run(
        _requests(jcfg, BURST, cls=JaxServeRequest))
    assert len(done) == len(BURST)
    for r, jr in zip(done, jax_done):
        assert r.out == refs[r.rid], f"req {r.rid} diverged from oracle"
        assert r.out == jr.out, f"req {r.rid} diverged from reference"


def test_padded_prefill_leaves_other_slots_bit_identical():
    """A 3-row bucket padded to 4 rows: the pad row (out-of-range slot)
    must land nowhere — not in the live slot, not in the last free slot a
    clamped index would hit."""
    _, tcfg, _, bundle, tp = _port()
    engine = ServeEngine(bundle, tp, EngineConfig(
        slots=5, cache_len=CACHE_LEN, pad_to=8, max_prefill_batch=4),
        device="cpu")
    first, *rest = _requests(tcfg, [(9, 20), (5, 4), (6, 4), (7, 4)])
    engine.submit(first)
    engine._admit(0.0)
    engine.step(0.0)                      # slot 0 live, mid-decode
    engine.cache["k"][:, 4] = 7.0         # marker in the slot left free
    engine.cache["v"][:, 4] = 7.0
    before = {k: v.clone() for k, v in engine.cache.items()}
    for r in rest:
        engine.submit(r)
    assert engine._admit(1.0) == 3 and engine.prefill_calls == 2
    for key in ("k", "v"):
        for slot in (0, 4):
            assert torch.equal(engine.cache[key][:, slot],
                               before[key][:, slot])
    assert engine.cache["lens"].tolist() == [10, 5, 6, 7, 0]


def test_engine_failure_semantics_keep_parity():
    """Deadline expiry (prefix of the oracle), bounded-queue rejection and
    drain, each as the reference engine defines them."""
    _, tcfg, _, bundle, tp = _port()
    reqs = _requests(tcfg, [(5, 20), (7, 6), (6, 8), (4, 3), (8, 3)])
    refs = _refs(bundle, tp, reqs)
    reqs[0].deadline_s = 5.0
    engine = ServeEngine(bundle, tp, EngineConfig(
        slots=2, cache_len=CACHE_LEN, pad_to=1, max_queue=3), device="cpu")
    done = {r.rid: r for r in engine.run(reqs)}
    assert done[0].expired and 0 < len(done[0].out) < 20
    assert done[0].out == refs[0][:len(done[0].out)]
    assert [r.rid for r in done.values() if r.rejected] == [3, 4]
    assert done[1].out == refs[1] and done[2].out == refs[2]
    assert done[2].t_admit >= 5.0       # took the expired request's slot

    reqs = _requests(tcfg, [(5, 8), (9, 6), (6, 10)], seed=1)
    refs = _refs(bundle, tp, reqs)
    engine = ServeEngine(bundle, tp, EngineConfig(
        slots=2, cache_len=CACHE_LEN, pad_to=1), device="cpu")
    for r in reqs:
        engine.submit(r)
    engine._admit(0.0)
    engine.step(0.0)
    drained = engine.drain()
    assert sorted(r.rid for r in drained) == [0, 1]
    assert all(r.out == refs[r.rid] for r in drained)
    assert [r.rid for r in engine.waiting] == [2]


def test_batched_server_matches_oracle():
    _, tcfg, _, bundle, tp = _port()
    reqs = _requests(tcfg, [(4, 8), (17, 8), (9, 8), (26, 8)])
    refs = _refs(bundle, tp, reqs)
    server = launch_serve.BatchedServer(bundle, tp, slots=4,
                                        cache_len=CACHE_LEN, device="cpu")
    for r in server.run(reqs, log=lambda *_: None):
        assert r.out == refs[r.rid]


@pytest.mark.parametrize("mode", ["engine", "wave"])
def test_launch_main_runs_on_cpu(mode, capsys):
    argv = ["--arch", "qwen2-0.5b", "--device", "cpu", "--requests", "3",
            "--max-new", "4"]
    launch_serve.main(argv + (["--engine"] if mode == "engine" else []))
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out
    assert ("engine stats" in out) == (mode == "engine")


def test_unported_options_raise():
    """Every family is ported: the encoder-decoder in models/encdec.py
    (tests/test_torch_encdec.py).  Its bundle has no slotted serving path,
    as the reference's has none, and the LM module refuses it; the MoE
    family, the paged cache, the fault hook and the router are tested in
    tests/test_torch_moe.py, tests/test_torch_serve_paged.py and
    tests/test_torch_router.py."""
    _, tcfg, _, bundle, tp = _port()
    encdec = dataclasses.replace(tcfg, family="encdec")
    assert build_model(encdec).decode_slotted is None
    with pytest.raises(ValueError, match="encdec"):
        init_lm(0, encdec, device="cpu")


ENTRY_POINTS = {
    "init_lm": lambda cfg, bundle, p: init_lm(0, cfg),
    "make_slot_cache": lambda cfg, bundle, p: bundle.make_slot_cache(2, 8),
    "make_paged_cache": lambda cfg, bundle, p: bundle.make_paged_cache(
        2, 16, 4, 8),
    "engine": lambda cfg, bundle, p: ServeEngine(bundle, p),
    "paged_engine": lambda cfg, bundle, p: ServeEngine(
        bundle, p, EngineConfig(paged=True)),
    "router": lambda cfg, bundle, p: ReplicaRouter(bundle, p),
    "greedy_reference": lambda cfg, bundle, p: greedy_reference(
        bundle, p, np.arange(3, dtype=np.int32), 2, 8),
    "params_from_jax": lambda cfg, bundle, p: params_from_jax(
        {"embed": np.zeros((4, 2), np.float32),
         "layers": {"attn_norm": {"scale": np.ones((1, 2), np.float32)}},
         "final_norm": {"scale": np.ones(2, np.float32)}}),
    "launcher": lambda cfg, bundle, p: launch_serve.main(["--engine"]),
    "launcher_router": lambda cfg, bundle, p: launch_serve.main(
        ["--router", "--paged"]),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_point_without_device_raises_without_card(entry, monkeypatch):
    """No device and no card: raise, never drift onto the CPU."""
    _, tcfg, _, bundle, tp = _port()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry](tcfg, bundle, tp)
