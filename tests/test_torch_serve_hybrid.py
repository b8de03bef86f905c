"""The port's serving engine on the SSM and hybrid families, on the CPU.

Greedy tokens of the dense-slot and the paged engine equal the port's
one-request oracle (``greedy_reference``) for a burst of mixed prompt and
output lengths, paged tokens equal dense tokens, and the dense engine's
equal the reference engine's on the same weights.  The paged engine
splices each prefill row's conv/SSM states into its slot beside the pool
(the reference's ``_row_specs``); without that the paged tokens diverge.
"""
import numpy as np
import pytest
import torch

from repro.models.registry import build_model as jax_build_model
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import ServeRequest as JaxServeRequest
from repro_torch.launch import serve as launch_serve
from repro_torch.models.registry import build_model
from repro_torch.serve import (
    EngineConfig,
    ServeEngine,
    ServeRequest,
    greedy_reference,
)
from torch_parity import (  # noqa: F401 (one_thread: a fixture)
    HYBRID_ARCHS,
    hybrid_configs,
    hybrid_params,
    one_thread,
)

CACHE_LEN = 48
# (prompt length, max_new): repeated lengths share exact-length buckets
BURST = [(4, 6), (11, 3), (7, 9), (11, 5), (5, 5), (9, 8), (13, 4), (4, 7)]


def _port(arch):
    jcfg, tcfg = hybrid_configs(arch)
    jp, tp = hybrid_params(jcfg)
    return jcfg, tcfg, jp, build_model(tcfg), tp


def _requests(cfg, cls=ServeRequest, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, cfg.vocab_size, pl).astype(
                np.int32), max_new=mn)
            for i, (pl, mn) in enumerate(BURST)]


def _ecfg(paged=False):
    return EngineConfig(slots=3, cache_len=CACHE_LEN, pad_to=1,
                        max_prefill_batch=3, paged=paged, block_size=8)


@pytest.mark.parametrize("arch", HYBRID_ARCHS)
def test_engines_match_oracle_and_each_other(arch):
    _, tcfg, _, bundle, tp = _port(arch)
    reqs = _requests(tcfg)
    refs = {r.rid: greedy_reference(bundle, tp, r.prompt, r.max_new,
                                    CACHE_LEN, device="cpu") for r in reqs}
    dense = ServeEngine(bundle, tp, _ecfg(), device="cpu")
    paged = ServeEngine(bundle, tp, _ecfg(paged=True), device="cpu")
    out_dense = dense.run(_requests(tcfg))
    out_paged = paged.run(_requests(tcfg))
    assert len(out_dense) == len(out_paged) == len(BURST)
    assert dense.stats()["peak_concurrency"] == 3
    for d, p in zip(out_dense, out_paged):
        assert d.out == refs[d.rid], f"dense req {d.rid} left the oracle"
        assert p.out == refs[p.rid], f"paged req {p.rid} left the oracle"
        assert p.done and not p.oom and len(p.out) == p.max_new


def test_dense_engine_matches_reference_engine():
    """Reduced zamba2-7b through both packages' dense engines."""
    jcfg, tcfg, jp, bundle, tp = _port("zamba2-7b")
    ecfg = dict(slots=3, cache_len=CACHE_LEN, pad_to=1, max_prefill_batch=3)
    done = ServeEngine(bundle, tp, EngineConfig(**ecfg), device="cpu").run(
        _requests(tcfg))
    jax_done = JaxServeEngine(jax_build_model(jcfg), jp,
                              JaxEngineConfig(**ecfg)).run(
        _requests(jcfg, cls=JaxServeRequest))
    for r, jr in zip(done, jax_done):
        assert r.out == jr.out, f"req {r.rid} diverged from the reference"


def test_paged_splice_writes_row_states_into_their_slots():
    """After one admission tick, each admitted slot's conv/SSM states are
    the prefill's, and the K/V rows sit in the slot's pool blocks."""
    _, tcfg, _, bundle, tp = _port("zamba2-7b")
    engine = ServeEngine(bundle, tp, _ecfg(paged=True), device="cpu")
    reqs = _requests(tcfg)[:3]
    for r in reqs:
        engine.submit(r)
    engine._admit(0.0)
    for slot, r in enumerate(engine.active):
        toks = torch.from_numpy(r.prompt)[None]
        _, rows = bundle.prefill_paged(tp, {
            "tokens": toks, "lens": torch.tensor([len(r.prompt)],
                                                 dtype=torch.int32)})
        for key, ax in (("conv", 2), ("ssm", 2), ("conv_tail", 1),
                        ("ssm_tail", 1)):
            assert torch.equal(engine.cache[key].select(ax, slot),
                               rows[key].select(ax, 0)), key
        blocks = engine.pool.slot_blocks(slot)
        pos = np.arange(len(r.prompt))
        blk = torch.as_tensor(np.asarray(blocks)[pos // 8])
        off = torch.as_tensor(pos % 8)
        assert torch.equal(engine.cache["k"][:, blk, off], rows["k"][:, 0])
        assert int(engine.cache["lens"][slot]) == len(r.prompt)


def test_padded_buckets_are_refused():
    """SSM states fold every prompt token: right-padded buckets would
    corrupt them, so an engine with pad_to > 1 is refused."""
    _, _, _, bundle, tp = _port("mamba2-780m")
    with pytest.raises(ValueError, match="pad_to=1"):
        ServeEngine(bundle, tp, EngineConfig(pad_to=8), device="cpu")


@pytest.mark.parametrize("arch", HYBRID_ARCHS)
@pytest.mark.parametrize("mode", [["--engine"], ["--engine", "--paged"],
                                  ["--router", "--paged"]],
                         ids=["engine", "paged", "router"])
def test_launch_main_serves_hybrids_on_cpu(arch, mode, capsys):
    launch_serve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                       "--max-new", "4"] + mode)
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and f"{arch}-smoke" in out
