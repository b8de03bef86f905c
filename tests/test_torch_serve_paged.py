"""Port paged serving engine on the CPU: token parity with the reference's
paged engine and with the port's own dense engine and oracle, and the
reference's own paged contracts (tests/test_serve_paged.py, LM family):
block-granular admission beats dense slots at equal memory, a dry pool
sheds explicitly with prefix parity, a splice under a full pool leaves
resident blocks bit-identical, and over-pool prompts are rejected.  Also
the ``serve.decode`` fault hook, against the reference engine."""
import numpy as np
import pytest
import torch

from repro.core.faults import FaultPlan as JaxFaultPlan
from repro.core.faults import stall_every as jax_stall_every
from repro.models.registry import build_model as jax_build_model
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import ServeRequest as JaxServeRequest
from repro_torch.core.faults import FaultPlan, stall_every
from repro_torch.launch import serve as launch_serve
from repro_torch.models.registry import build_model
from repro_torch.serve import (
    BlockPool,
    EngineConfig,
    ServeEngine,
    ServeRequest,
    blocks_for,
    greedy_reference,
)
from torch_parity import (  # noqa: F401 (one_thread: a fixture)
    SERVED_ARCHS,
    configs,
    one_thread,
    params,
)

CACHE_LEN = 48
BS = 8                      # block size used throughout
MIXED = [(5, 6), (12, 4), (31, 5), (8, 8), (4, 6), (19, 4)]


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


def _paged(slots=6, n_blocks=None, pad_to=8, cls=EngineConfig, **kw):
    return cls(slots=slots, cache_len=CACHE_LEN, pad_to=pad_to, paged=True,
               block_size=BS, n_blocks=n_blocks, **kw)


# ------------------------------------------------------- engine parity
@pytest.mark.parametrize("arch", SERVED_ARCHS)
def test_paged_engine_matches_reference_paged_engine(arch):
    """The same requests through both packages' paged engines (4 slots,
    an 18-block pool): equal tokens, equal stats, and every request equal
    to the port's scalar oracle."""
    jcfg, tcfg, jp, bundle, tp = _port(arch)
    reqs = _requests(tcfg, MIXED, seed=1)
    refs = _refs(bundle, tp, reqs)
    engine = ServeEngine(bundle, tp, _paged(slots=4, n_blocks=18),
                         device="cpu")
    done = engine.run(reqs)
    jax_engine = JaxServeEngine(jax_build_model(jcfg), jp,
                                _paged(slots=4, n_blocks=18,
                                       cls=JaxEngineConfig))
    jax_done = jax_engine.run(_requests(jcfg, MIXED, cls=JaxServeRequest,
                                        seed=1))
    assert len(done) == len(MIXED) and not any(r.oom for r in done)
    for r, jr in zip(done, jax_done):
        assert r.out == refs[r.rid] == jr.out, r.rid
        assert r.blocks_held == jr.blocks_held
        assert r.blocks_held >= blocks_for(len(r.prompt), BS)
    assert engine.stats() == jax_engine.stats()


@pytest.mark.parametrize("arch", SERVED_ARCHS)
def test_paged_engine_equals_dense_engine_at_full_span(arch):
    """NB*BS == cache_len and a worst-case pool: same admission order,
    same batches, same attention arithmetic, so the paged engine's tokens
    equal the dense engine's for every request."""
    _, tcfg, _, bundle, tp = _port(arch)
    reqs = _requests(tcfg, MIXED + [(40, 9), (3, 12)], seed=2)
    ecfg = dict(slots=4, cache_len=CACHE_LEN, pad_to=8, max_prefill_batch=4)
    dense = ServeEngine(bundle, tp, EngineConfig(**ecfg), device="cpu")
    paged = ServeEngine(bundle, tp, EngineConfig(
        **ecfg, paged=True, block_size=BS), device="cpu")
    d_out = {r.rid: r.out for r in dense.run(reqs)}
    p_done = paged.run(_requests(tcfg, MIXED + [(40, 9), (3, 12)], seed=2))
    assert all(r.out == d_out[r.rid] for r in p_done)
    assert paged.stats()["n_blocks"] == 4 * CACHE_LEN // BS
    assert paged.stats()["shed_blocks"] == 0


# --------------------------------------------- the reference's contracts
def test_paged_admission_beats_dense_at_equal_memory():
    """Equal KV memory (same pooled token count): the paged engine admits
    strictly more concurrent sequences than worst-case dense slots."""
    _, tcfg, _, bundle, tp = _port()
    reqs = _requests(tcfg, [(4, 4)] * 12, seed=2)
    refs = _refs(bundle, tp, reqs)
    dense = ServeEngine(bundle, tp, EngineConfig(
        slots=2, cache_len=CACHE_LEN, pad_to=8), device="cpu")
    dense_done = dense.run([ServeRequest(rid=r.rid, prompt=r.prompt,
                                         max_new=r.max_new) for r in reqs])
    paged = ServeEngine(bundle, tp, _paged(
        slots=12, n_blocks=2 * CACHE_LEN // BS), device="cpu")
    paged_done = paged.run(reqs)
    assert all(r.out == refs[r.rid] for r in dense_done)
    assert all(r.out == refs[r.rid] for r in paged_done)
    assert not any(r.oom for r in paged_done)
    assert dense.stats()["peak_concurrency"] == 2
    assert paged.stats()["peak_concurrency"] >= 4


def test_paged_oom_shed_explicit_prefix_parity():
    """A pool too small for the admitted set's growth sheds the youngest
    admission explicitly: ``oom`` flagged, output a prefix of the oracle,
    ``shed_blocks`` counted, every request returned; the same requests
    shed as in the reference engine."""
    jcfg, tcfg, jp, bundle, tp = _port()
    reqs = _requests(tcfg, [(7, 12)] * 6, seed=3)
    refs = _refs(bundle, tp, reqs)
    eng = ServeEngine(bundle, tp, _paged(slots=6, n_blocks=7), device="cpu")
    done = eng.run(reqs)
    jax_done = JaxServeEngine(jax_build_model(jcfg), jp, _paged(
        slots=6, n_blocks=7, cls=JaxEngineConfig)).run(
        _requests(jcfg, [(7, 12)] * 6, cls=JaxServeRequest, seed=3))
    assert len(done) == len(reqs)
    shed = [r for r in done if r.oom]
    assert shed and eng.stats()["shed_blocks"] == len(shed)
    assert [r.rid for r in shed] == [r.rid for r in jax_done if r.oom]
    for r in done:
        if r.oom:
            assert r.done and r.out == refs[r.rid][:len(r.out)]
        else:
            assert r.out == refs[r.rid]


def test_submit_rejects_prompts_over_cache_len_and_over_pool():
    _, tcfg, _, bundle, tp = _port()
    rng = np.random.default_rng(0)
    eng = ServeEngine(bundle, tp, _paged(n_blocks=3), device="cpu")
    with pytest.raises(ValueError, match="cache_len"):
        eng.submit(ServeRequest(rid=0, prompt=rng.integers(
            0, tcfg.vocab_size, CACHE_LEN + 1).astype(np.int32), max_new=2))
    with pytest.raises(ValueError, match="blocks"):
        eng.submit(ServeRequest(rid=1, prompt=rng.integers(
            0, tcfg.vocab_size, 3 * BS + 1).astype(np.int32), max_new=2))


def test_splice_under_full_pool_preserves_resident_blocks():
    """Admitting into a pool that fills completely leaves the blocks
    already resident bit-identical: the splice's sentinel rows (pad tail)
    land nowhere."""
    _, tcfg, _, bundle, tp = _port()
    rng = np.random.default_rng(4)
    a = ServeRequest(rid=0, prompt=rng.integers(
        0, tcfg.vocab_size, 2 * BS + 3).astype(np.int32), max_new=4)
    b = ServeRequest(rid=1, prompt=rng.integers(
        0, tcfg.vocab_size, 2 * BS + 5).astype(np.int32), max_new=4)
    eng = ServeEngine(bundle, tp, _paged(slots=4, n_blocks=6), device="cpu")
    eng.submit(a)
    eng.tick(0.0)                       # admit + prefill + 1 decode step
    a_blocks = eng.pool.slot_blocks(0)[:2]   # full, not written again
    frozen = eng.cache["k"][:, a_blocks].clone()
    eng.submit(b)
    eng.tick(1.0)                       # B's splice fills the pool
    assert eng.pool.free_count == 0
    assert torch.equal(eng.cache["k"][:, a_blocks], frozen)
    refs = _refs(bundle, tp, [a, b])
    for r in eng.drain():
        assert r.out == refs[r.rid]


def test_block_pool_alloc_free_roundtrip():
    pool = BlockPool(n_blocks=8, block_size=4, slots=3,
                     max_blocks_per_slot=4)
    assert pool.alloc(0, 3) and pool.alloc(1, 2) and pool.peak_used == 5
    assert not pool.alloc(2, 4)         # all-or-nothing
    assert pool.free_count == 3 and pool.held(2) == 0
    assert pool.free_slot(0) == 3 and pool.peak_used == 5
    assert pool.alloc(0, 1) and not pool.alloc(0, 4)  # per-slot cap
    t = pool.table_array()
    assert t.dtype == np.int32 and (t[2] == 8).all()  # sentinel = n_blocks


def test_cancel_and_deadline_release_blocks():
    """Every path that frees a slot returns its blocks: cancel, deadline
    expiry and drain leave the pool full again."""
    _, tcfg, _, bundle, tp = _port()
    reqs = _requests(tcfg, [(9, 20), (5, 20), (17, 3)], seed=5)
    reqs[1].deadline_s = 2.0
    eng = ServeEngine(bundle, tp, _paged(slots=3, n_blocks=12),
                      device="cpu")
    for r in reqs:
        eng.submit(r)
    eng.tick(0.0)
    assert eng.pool.free_count == 12 - 2 - 1 - 3
    assert eng.cancel(0) is reqs[0] and reqs[0].blocks_held == 2
    eng.tick(1.0)
    eng.tick(2.0)                       # rid 1 expires at t=2
    assert reqs[1].expired and reqs[1].blocks_held >= 1
    eng.drain()
    assert eng.pool.free_count == 12 and not eng.has_work
    assert eng.stats()["free_blocks"] == 12


# ------------------------------------------------------- fault hook
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_stall_advances_the_virtual_clock_as_reference(paged):
    """``serve.decode`` stalls push the virtual clock on: deadlines fire
    earlier in decode steps, exactly as in the reference engine."""
    jcfg, tcfg, jp, bundle, tp = _port()
    lens = [(6, 10), (9, 10), (5, 4), (7, 6)]
    reqs = _requests(tcfg, lens, seed=6)
    jreqs = _requests(jcfg, lens, cls=JaxServeRequest, seed=6)
    for r in reqs + jreqs:
        r.deadline_s = 12.0
    kw = dict(slots=2, cache_len=CACHE_LEN, pad_to=1, paged=paged,
              block_size=BS)
    plan, jplan = FaultPlan([stall_every(3, 2.5)]), \
        JaxFaultPlan([jax_stall_every(3, 2.5)])
    done = ServeEngine(bundle, tp, EngineConfig(**kw), faults=plan,
                       device="cpu").run(reqs)
    jdone = JaxServeEngine(jax_build_model(jcfg), jp, JaxEngineConfig(**kw),
                           faults=jplan).run(jreqs)
    assert plan.hits("serve.decode") == jplan.hits("serve.decode") > 0
    assert len(plan.fired()) == len(jplan.fired()) > 0
    assert any(r.expired for r in done)
    for r, jr in zip(done, jdone):
        assert (r.out, r.expired, r.t_done) == (jr.out, jr.expired, jr.t_done)


def test_launch_main_paged_engine_runs_on_cpu(capsys):
    launch_serve.main(["--arch", "qwen2-0.5b", "--device", "cpu", "--engine",
                       "--paged", "--requests", "3", "--max-new", "4",
                       "--block-size", "8"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out
    assert "'block_size': 8" in out and "'shed_blocks': 0" in out
