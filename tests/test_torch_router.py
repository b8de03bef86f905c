"""Port replica router, fault plan and load generators on the CPU, against
the reference: equal outputs and equal ``stats`` on the same workloads
(dense and paged replicas), the chaos drill under replica loss and stall
(tests/test_faults.py), shedding, hedging, drain, and the launcher."""
import numpy as np
import pytest

from repro.core import faults as jax_faults
from repro.models.registry import build_model as jax_build_model
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import ReplicaRouter as JaxReplicaRouter
from repro.serve import RouterConfig as JaxRouterConfig
from repro.serve import ServeRequest as JaxServeRequest
from repro.serve import loadgen as jax_loadgen
from repro_torch.core import faults
from repro_torch.core.faults import FaultPlan, FaultSpec
from repro_torch.launch import serve as launch_serve
from repro_torch.models.registry import build_model
from repro_torch.serve import (
    EngineConfig,
    ReplicaRouter,
    RouterConfig,
    ServeRequest,
    greedy_reference,
    loadgen,
)
from torch_parity import configs, one_thread, params  # noqa: F401 (a fixture)

CACHE_LEN = 48
BS = 8
CPU = ["cpu"]


def _port(arch="qwen2-0.5b"):
    jcfg, tcfg = configs(arch)
    jp, tp = params(jcfg)
    return jcfg, tcfg, jp, build_model(tcfg), tp


def _requests(cfg, triples, cls=ServeRequest, seed=0):
    """(prompt_len, max_new, arrival_s) triples."""
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, cfg.vocab_size, pl).astype(
                np.int32), max_new=mn, arrival_s=arr)
            for i, (pl, mn, arr) in enumerate(triples)]


def _refs(bundle, params_, reqs):
    return {r.rid: greedy_reference(bundle, params_, r.prompt, r.max_new,
                                    CACHE_LEN, device="cpu") for r in reqs}


def _engine(cls, paged=False, **kw):
    base = dict(slots=2, cache_len=CACHE_LEN, pad_to=4, max_prefill_batch=2)
    if paged:
        base.update(paged=True, block_size=BS)
    return cls(**{**base, **kw})


def _both(router_kw, engine_kw, jax_plan=None, plan=None, arch="qwen2-0.5b"):
    """(port router, reference router) over the same weights."""
    jcfg, tcfg, jp, bundle, tp = _port(arch)
    ours = ReplicaRouter(bundle, tp, RouterConfig(
        engine=_engine(EngineConfig, **engine_kw), **router_kw),
        faults=plan, devices=CPU)
    ref = JaxReplicaRouter(jax_build_model(jcfg), jp, JaxRouterConfig(
        engine=_engine(JaxEngineConfig, **engine_kw), **router_kw),
        faults=jax_plan)
    return tcfg, bundle, tp, ours, ref


def _same_run(ours, ref, reqs, jreqs):
    done, jdone = ours.run(reqs), ref.run(jreqs)
    assert [r.rid for r in done] == [r.rid for r in jdone]
    for r, jr in zip(done, jdone):
        assert (r.out, r.done, r.expired, r.rejected, r.oom,
                r.blocks_held) == (jr.out, jr.done, jr.expired, jr.rejected,
                                   jr.oom, jr.blocks_held), r.rid
    assert ours.stats == ref.stats
    return done


# ---------------------------------------------------------- router parity
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_router_matches_reference_on_longtail_workload(paged):
    """A long-tail burst over two replicas: equal outputs, equal stats,
    and every request equal to the port's scalar oracle."""
    ekw = dict(slots=3, paged=paged)
    if paged:
        ekw["n_blocks"] = 12
    tcfg, bundle, tp, ours, ref = _both(dict(replicas=2), ekw)
    kw = dict(rate_per_s=0.0, median_prompt=6, sigma=0.8,
              max_prompt=CACHE_LEN - BS, out_lens=(4, 6, 8), seed=5)
    reqs = loadgen.longtail_workload(10, vocab_size=tcfg.vocab_size, **kw)
    jreqs = jax_loadgen.longtail_workload(10, vocab_size=tcfg.vocab_size,
                                          **kw)
    refs = _refs(bundle, tp, reqs)
    done = _same_run(ours, ref, reqs, jreqs)
    for r in done:
        if not r.oom:
            assert r.out == refs[r.rid]
    if paged:
        assert ours.stats["peak_blocks_used"] <= 12
        assert ours.stats["shed_blocks"] == sum(r.oom for r in done)


def test_router_greedy_parity_no_faults():
    """Open-loop arrivals over two replicas: both serve work, accounting
    balances, tokens equal the oracle and the reference router's."""
    triples = [(4, 6, 0.0), (8, 5, 0.0), (6, 4, 2.0), (5, 7, 3.0),
               (7, 3, 5.0), (4, 6, 8.0)]
    tcfg, bundle, tp, ours, ref = _both(dict(replicas=2), {})
    reqs = _requests(tcfg, triples)
    refs = _refs(bundle, tp, reqs)
    done = _same_run(ours, ref, reqs, _requests(tcfg, triples,
                                                cls=JaxServeRequest))
    assert all(r.out == refs[r.rid] for r in done)
    s = ours.stats
    assert s["admitted"] == s["completed"] == s["dispatches"] == 6
    assert all(rep.engine.decode_steps > 0 for rep in ours.replicas)


def _chaos_plans():
    def specs(mod):
        return [
            mod.FaultSpec(site="serve.replica", kind="device_loss",
                          when=lambda c: c["replica"] == 0
                          and c["tick"] == 3),
            mod.FaultSpec(site="serve.replica", kind="stall", hang_s=6.0,
                          times=1, when=lambda c: c["replica"] == 1
                          and c["tick"] == 5)]
    return FaultPlan(specs(faults)), jax_faults.FaultPlan(specs(jax_faults))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_router_chaos_parity_under_replica_loss_and_stall(paged):
    """The reference's chaos drill: replica 0 is lost mid-decode
    (quarantine + failover), replica 1 silently stalls (heartbeat evicts
    and restarts).  Every admitted request comes back equal to the
    fault-free oracle, overflow is shed explicitly, nothing is dropped;
    outputs and stats equal the reference router's."""
    arrivals = [0.0, 0.0, 0.0, 0.0, 2.0, 3.0, 5.0, 8.0]
    triples = [(4 + i % 5, 4 + i % 4, a) for i, a in enumerate(arrivals)]
    plan, jplan = _chaos_plans()
    tcfg, bundle, tp, ours, ref = _both(
        dict(replicas=2, max_queue=3, heartbeat_misses=2),
        dict(paged=paged), jax_plan=jplan, plan=plan)
    reqs = _requests(tcfg, triples)
    refs = _refs(bundle, tp, reqs)
    done = _same_run(ours, ref, reqs,
                     _requests(tcfg, triples, cls=JaxServeRequest))
    s = ours.stats
    assert [r.rid for r in done] == list(range(len(reqs)))
    assert s["admitted"] + s["shed_queue"] + s["shed_deadline"] == len(reqs)
    shed = [r for r in done if r.rejected]
    assert len(shed) == s["shed_queue"] >= 1
    assert all(not r.out and not r.done for r in shed)
    assert plan.fired("serve.replica", kind="device_loss")
    assert plan.fired("serve.replica", kind="stall")
    assert s["quarantined"] == [0]
    assert not ours.replicas[0].live and ours.replicas[1].live
    assert s["failovers"] >= 1 and s["restarts"] >= 1
    for r in done:
        if not r.rejected:
            assert not r.expired and r.out == refs[r.rid], r.rid


def test_router_dispatch_fault_redispatches():
    """A crash at the hand-off itself: the replica is failed and
    restarted, the request requeued, and all complete as the oracle."""
    def spec(mod):
        return [mod.FaultSpec(site="router.dispatch", kind="crash",
                              at=(2,))]
    plan, jplan = FaultPlan(spec(faults)), jax_faults.FaultPlan(
        spec(jax_faults))
    tcfg, bundle, tp, ours, ref = _both(dict(replicas=2), {},
                                        jax_plan=jplan, plan=plan)
    triples = [(5, 4, 0.0)] * 4
    reqs = _requests(tcfg, triples, seed=1)
    refs = _refs(bundle, tp, reqs)
    done = _same_run(ours, ref, reqs, _requests(tcfg, triples,
                                                cls=JaxServeRequest, seed=1))
    assert plan.fired("router.dispatch", kind="crash")
    assert ours.stats["restarts"] >= 1
    assert all(r.out == refs[r.rid] for r in done)


def test_router_queue_and_deadline_shedding_is_explicit():
    tcfg, bundle, tp, ours, ref = _both(dict(replicas=1, max_queue=4), {})
    triples = [(4, 4, 0.0)] * 10
    done = _same_run(ours, ref, _requests(tcfg, triples, seed=1),
                     _requests(tcfg, triples, cls=JaxServeRequest, seed=1))
    assert sum(r.rejected for r in done) == ours.stats["shed_queue"] == 6

    tcfg, bundle, tp, ours, ref = _both(dict(replicas=1),
                                        dict(slots=1, max_prefill_batch=1))
    warm = [(4, 3, 0.0), (4, 3, 4.0), (4, 3, 8.0)]
    burst = [(4, 3, 20.0)] * 6

    def reqs(cls):
        out = _requests(tcfg, warm, cls=cls, seed=2)
        for i, r in enumerate(_requests(tcfg, burst, cls=cls, seed=3)):
            r.rid, r.deadline_s = 10 + i, 1.0
            out.append(r)
        return out
    _same_run(ours, ref, reqs(ServeRequest), reqs(JaxServeRequest))
    s = ours.stats
    assert s["shed_deadline"] == 5 and s["completed"] == 3
    assert s["expired"] == 1


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_router_hedges_straggler_first_completion_wins(paged):
    def spec(mod):
        return [mod.FaultSpec(site="serve.replica", kind="stall",
                              hang_s=30.0, times=1,
                              when=lambda c: c["replica"] == 0
                              and c["tick"] == 12)]
    plan, jplan = FaultPlan(spec(faults)), jax_faults.FaultPlan(
        spec(jax_faults))
    tcfg, bundle, tp, ours, ref = _both(
        dict(replicas=2, hedge=True, hedge_percentile=90.0,
             hedge_min_samples=4, heartbeat_misses=50), dict(paged=paged),
        jax_plan=jplan, plan=plan)
    triples = [(4, 4, float(i)) for i in range(20)]
    reqs = _requests(tcfg, triples, seed=4)
    refs = _refs(bundle, tp, reqs)
    done = _same_run(ours, ref, reqs, _requests(tcfg, triples,
                                                cls=JaxServeRequest, seed=4))
    assert all(r.out == refs[r.rid] for r in done)
    assert ours.stats["hedges"] >= 1 and ours.stats["hedge_wins"] >= 1


def test_router_drain_completes_in_flight_only():
    tcfg, bundle, tp, ours, _ = _both(dict(replicas=2), dict(paged=True))
    reqs = _requests(tcfg, [(4, 5, 0.0)] * 8, seed=5)
    refs = _refs(bundle, tp, reqs)
    ours.reset()
    for r in reqs:
        assert ours.submit(r)
    ours._dispatch(0.0)                # 4 slots filled, 4 left queued
    drained = ours.drain()
    assert {r.rid for r in drained} == {0, 1, 2, 3}
    assert all(r.out == refs[r.rid] for r in drained)
    assert [r.rid for r in ours.queue] == [4, 5, 6, 7]
    assert all(rep.engine.pool.free_count == rep.engine.pool.n_blocks
               for rep in ours.replicas)


def test_router_rejects_prompt_over_pool():
    tcfg, bundle, tp, ours, _ = _both(dict(replicas=1),
                                      dict(paged=True, n_blocks=3))
    prompt = np.zeros(3 * BS + 1, np.int32)
    with pytest.raises(ValueError, match="blocks"):
        ours.submit(ServeRequest(rid=1, prompt=prompt, max_new=2))


def test_router_shares_params_on_one_device():
    _, _, _, bundle, tp = _port()
    router = ReplicaRouter(bundle, tp, RouterConfig(
        replicas=2, engine=_engine(EngineConfig)), devices=CPU)
    assert all(rep.engine.params["embed"] is tp["embed"]
               for rep in router.replicas)


# ------------------------------------------------------------ load gen
WORKLOADS = {
    "poisson": ("poisson_workload", dict(rate_per_s=10.0)),
    "poisson_burst": ("poisson_workload", dict(rate_per_s=0.0)),
    "gamma": ("gamma_workload", dict(rate_per_s=2.0, cv=4.0)),
    "onoff": ("onoff_workload", dict(rate_per_s=5.0, on_s=2.0, off_s=3.0)),
    "longtail": ("longtail_workload", dict(rate_per_s=5.0, median_prompt=6,
                                           max_prompt=40)),
}


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_workloads_equal_reference(name):
    fn, kw = WORKLOADS[name]
    a = getattr(loadgen, fn)(24, vocab_size=64, seed=3, **kw)
    b = getattr(jax_loadgen, fn)(24, vocab_size=64, seed=3, **kw)
    assert [(r.rid, r.arrival_s, r.max_new) for r in a] == \
        [(r.rid, r.arrival_s, r.max_new) for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


def test_latency_stats_equal_reference():
    reqs = loadgen.poisson_workload(6, vocab_size=64, rate_per_s=3.0, seed=1)
    jreqs = jax_loadgen.poisson_workload(6, vocab_size=64, rate_per_s=3.0,
                                         seed=1)
    for i, (r, jr) in enumerate(zip(reqs, jreqs)):
        for x in (r, jr):
            x.t_arrival, x.t_first, x.t_done = x.arrival_s, \
                x.arrival_s + 0.1 * i, x.arrival_s + 0.5 * i + 1
            x.out = [1] * (i + 1)
    assert loadgen.latency_stats(reqs) == jax_loadgen.latency_stats(jreqs)
    assert loadgen.latency_stats(reqs, makespan_s=9.0) == \
        jax_loadgen.latency_stats(jreqs, makespan_s=9.0)


def test_fault_plan_matches_reference():
    """The copy fires the same specs at the same hits as the reference."""
    def plan(mod):
        return mod.FaultPlan([mod.stall_every(3, 1.5), mod.FaultSpec(
            site="serve.replica", kind="device_loss", at=(2, 5)),
            mod.crash_every(2, site="scheduler.job")])
    ours, ref = plan(faults), plan(jax_faults)
    for i in range(12):
        for site, ctx in (("serve.decode", {"step": i}),
                          ("serve.replica", {"replica": i % 2}),
                          ("scheduler.job", {"job_id": i, "attempt": 1})):
            a, b = ours.check(site, **ctx), ref.check(site, **ctx)
            assert (a is None) == (b is None)
            if a is not None:
                assert (a.kind, a.hang_s) == (b.kind, b.hang_s)
    assert [(e.site, e.hit, e.kind) for e in ours.fired()] == \
        [(e.site, e.hit, e.kind) for e in ref.fired()]
    with pytest.raises(faults.DeviceLost):
        FaultPlan([FaultSpec(site="x", kind="device_loss", at=(1,))]).fire(
            "x")


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_launch_main_router_runs_on_cpu(paged, capsys):
    launch_serve.main(["--arch", "qwen2-0.5b", "--device", "cpu", "--router",
                       "--replicas", "2", "--requests", "5", "--max-new",
                       "3"] + (["--paged"] if paged else []))
    out = capsys.readouterr().out
    assert "served 5 requests, 15 tokens" in out
    assert "router stats" in out and "'completed': 5" in out
    assert ("peak_blocks_used" in out) == paged
