"""The port's serving stack on the MoE family, on the CPU.

Capacity depends on the token count of each call (pad tokens and inactive
slots are routed too), so a batched engine and the one-request oracle may
drop different pairs, in ``repro`` as here.  The port's engines are
therefore held against ``repro``'s engine on the same requests, slots and
buckets, token for token; its paged engine against its dense one; and its
router, losing a replica mid-run, against ``repro``'s router under the
same fault plan.
"""
import numpy as np
import pytest

from repro.core import faults as jax_faults
from repro.models.registry import build_model as jax_build_model
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import ReplicaRouter as JaxReplicaRouter
from repro.serve import RouterConfig as JaxRouterConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import ServeRequest as JaxServeRequest
from repro_torch.core import faults
from repro_torch.launch import serve as launch_serve
from repro_torch.models.registry import build_model
from repro_torch.serve import (
    EngineConfig,
    ReplicaRouter,
    RouterConfig,
    ServeEngine,
    ServeRequest,
)
from torch_parity import (  # noqa: F401 (one_thread: a fixture)
    MOE_ARCHS,
    configs,
    one_thread,
    params,
)

CACHE_LEN = 48
# (prompt length, max_new): mixed lengths over 3 slots, buckets of 4
BURST = [(4, 6), (11, 3), (7, 9), (11, 5), (5, 5), (9, 8), (13, 4), (4, 7)]
ENGINE = dict(slots=3, cache_len=CACHE_LEN, pad_to=4, max_prefill_batch=3)


def _port(arch):
    jcfg, tcfg = configs(arch)
    jp, tp = params(jcfg)
    return jcfg, tcfg, jp, build_model(tcfg), tp


def _requests(cfg, cls=ServeRequest, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, cfg.vocab_size, pl).astype(
                np.int32), max_new=mn)
            for i, (pl, mn) in enumerate(BURST)]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_dense_engine_matches_reference_engine(arch):
    jcfg, tcfg, jp, bundle, tp = _port(arch)
    done = ServeEngine(bundle, tp, EngineConfig(**ENGINE),
                       device="cpu").run(_requests(tcfg))
    jax_done = JaxServeEngine(jax_build_model(jcfg), jp,
                              JaxEngineConfig(**ENGINE)).run(
        _requests(jcfg, cls=JaxServeRequest))
    assert [r.rid for r in done] == [r.rid for r in jax_done]
    for r, jr in zip(done, jax_done):
        assert r.out == jr.out, f"req {r.rid} diverged from the reference"
        assert r.done and len(r.out) == r.max_new


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_paged_engine_tokens_equal_dense_engine_tokens(arch):
    """Same buckets and batches in both engines, so the same pairs drop;
    decode at 3 slots never drops (cap 8 >= 3 tokens)."""
    _, tcfg, _, bundle, tp = _port(arch)
    dense = ServeEngine(bundle, tp, EngineConfig(**ENGINE), device="cpu")
    paged = ServeEngine(bundle, tp, EngineConfig(**ENGINE, paged=True,
                                                 block_size=8), device="cpu")
    out_dense = dense.run(_requests(tcfg))
    out_paged = paged.run(_requests(tcfg))
    assert dense.stats()["prefill_calls"] == paged.stats()["prefill_calls"]
    for d, p in zip(out_dense, out_paged):
        assert d.out == p.out, f"req {d.rid}: paged tokens differ"
        assert p.done and not p.oom and len(p.out) == p.max_new


def _loss_plan(mod):
    return mod.FaultPlan([mod.FaultSpec(
        site="serve.replica", kind="device_loss",
        when=lambda c: c["replica"] == 1 and c["tick"] == 3)])


def test_router_with_a_replica_lost_returns_every_request_once():
    """Two paged replicas of reduced dbrx-132b; replica 1 is lost a few
    ticks in.  Every request comes back once and done, the loss fails
    over, and outputs and stats equal the reference router's."""
    jcfg, tcfg, jp, bundle, tp = _port("dbrx-132b")
    engine = dict(ENGINE, slots=2, paged=True, block_size=8)
    plan = _loss_plan(faults)
    ours = ReplicaRouter(bundle, tp, RouterConfig(
        replicas=2, engine=EngineConfig(**engine)), faults=plan,
        devices=["cpu"])
    ref = JaxReplicaRouter(jax_build_model(jcfg), jp, JaxRouterConfig(
        replicas=2, engine=JaxEngineConfig(**engine)),
        faults=_loss_plan(jax_faults))
    done = ours.run(_requests(tcfg))
    jdone = ref.run(_requests(jcfg, cls=JaxServeRequest))
    assert [r.rid for r in done] == list(range(len(BURST)))
    assert all(r.done and not r.rejected for r in done)
    assert plan.fired("serve.replica", kind="device_loss")
    assert ours.stats["failovers"] >= 1 and ours.stats["quarantined"] == [1]
    assert [r.out for r in done] == [r.out for r in jdone]
    assert ours.stats == ref.stats


@pytest.mark.parametrize("mode", [["--engine"], ["--engine", "--paged"],
                                  ["--router", "--paged"]],
                         ids=["engine", "paged", "router"])
def test_launch_main_serves_dbrx_on_cpu(mode, capsys):
    launch_serve.main(["--arch", "dbrx-132b", "--device", "cpu",
                       "--requests", "3", "--max-new", "4"] + mode)
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "dbrx-132b-smoke" in out
