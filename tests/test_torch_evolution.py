"""The port's search loop (``core/evolution.py``) against ``repro``'s.

Both sides get the same deterministic injected trainer (a function of the
phenotype hash), so everything but training is the two packages' own
numpy code: the port must follow ``repro``'s trajectory bit for bit under
``pipeline="off"`` and ``"host_overlap"``, resume ``repro``'s checkpoints
(and ``repro`` the port's), and pick the same candidate for every goal.
The cases of tests/test_evolution.py and the search drills of
tests/test_faults.py run against the port as well.
"""
import json

import numpy as np
import pytest
import torch

from repro.core import evolution as revo
from repro.core import trainer as rtrainer
from repro.core.faults import FaultPlan as RFaultPlan
from repro.core.faults import crash_every as rcrash_every
from repro_torch.core import evolution as tevo
from repro_torch.core.faults import (
    FaultPlan,
    FaultSpec,
    crash_every,
    nan_candidate_every,
)
from repro_torch.core.objective_schema import pessimistic_expensive
from repro_torch.core.pareto import pareto_front
from repro_torch.core.trainer import TrainResult
from repro_torch.launch.mesh import local_search_devices

GOALS = ["low_energy", "low_power", "high_throughput", "balanced"]
HISTORY_KEYS = ("generation", "children", "trained", "population",
                "front_size", "feasible", "best_primary")


def _result(cls, g):
    """A deterministic result from the phenotype hash alone."""
    h = int(g.phenotype_hash()[:8], 16)
    return cls(detection_rate=0.80 + (h % 20) / 100.0,
               false_alarm_rate=((h >> 8) % 30) / 100.0,
               val_loss=0.1 + (h >> 16) % 7 / 10.0, steps=0)


def _trainers(cls, calls=None):
    """(scalar train_fn, batch_train_fn) for results of type ``cls``."""
    def scalar(g):
        if calls is not None:
            calls.append(g.phenotype_hash())
        return _result(cls, g)

    def batch(genomes, device=None):
        if calls is not None:
            calls.extend(g.phenotype_hash() for g in genomes)
        return [_result(cls, g) for g in genomes]
    return scalar, batch


def _search(pkg, pipeline="off", injected="batch", calls=None, faults=None,
            log=None, **kw):
    """A search of ``pkg`` (``revo`` or ``tevo``) with the shared trainer;
    the port's on the CPU."""
    cls = rtrainer.TrainResult if pkg is revo else TrainResult
    scalar, batch = _trainers(cls, calls)
    kw = {"generations": 4, "children_per_gen": 10, "n_accept": 4,
          "init_population": 8, "population_cap": 16, "n_workers": 2,
          "seed": 3, "pipeline": pipeline, **kw}
    extra = {"device": "cpu"} if pkg is tevo else {}
    if injected == "batch":
        extra["batch_train_fn"] = batch
    else:
        extra["train_fn"] = scalar
    return pkg.EvolutionarySearch(pkg.NASConfig(**kw), None, None,
                                  log=log or (lambda *_: None),
                                  faults=faults, **extra)


def _assert_same_trajectory(a, b):
    assert a.generation == b.generation
    assert list(a.pop.phash) == list(b.pop.phash)
    np.testing.assert_array_equal(a.pop.enc.op, b.pop.enc.op)
    np.testing.assert_array_equal(a.pop.enc.conn, b.pop.enc.conn)
    np.testing.assert_array_equal(a.pop.cheap, b.pop.cheap)
    np.testing.assert_array_equal(a.pop.expensive, b.pop.expensive)
    np.testing.assert_array_equal(a.pop.born, b.pop.born)
    assert set(a.evaluated_hashes) == set(b.evaluated_hashes)
    for h in a.evaluated_hashes:
        np.testing.assert_array_equal(a.evaluated_hashes[h],
                                      b.evaluated_hashes[h])
    assert len(a.history) == len(b.history)
    for ra, rb in zip(a.history, b.history):
        for k in HISTORY_KEYS:
            assert ra[k] == rb[k] or (
                np.isnan(ra[k]) and np.isnan(rb[k])), k


# ------------------------------------------------- the reference's trajectory

@pytest.mark.parametrize("injected", ["batch", "scalar"])
@pytest.mark.parametrize("pipeline", ["off", "host_overlap"])
def test_trajectory_equals_reference(pipeline, injected):
    want = _search(revo, pipeline, injected).run()
    got = _search(tevo, pipeline, injected).run()
    _assert_same_trajectory(got, want)


@pytest.mark.parametrize("backends", [None, ("fpga_zu", "tpu_roofline")],
                         ids=["fpga_zu", "multi"])
def test_trajectory_equals_reference_per_goal_and_platform(backends):
    """A goal-conditioned search, on one platform and on two."""
    kw = dict(goal="low_energy", generations=3)
    if backends:
        kw["backends"] = list(backends)
    want = _search(revo, "host_overlap", **kw).run()
    got = _search(tevo, "host_overlap", **kw).run()
    _assert_same_trajectory(got, want)


def test_host_overlap_equals_off_in_the_port():
    _assert_same_trajectory(_search(tevo, "host_overlap").run(),
                            _search(tevo, "off").run())


@pytest.mark.parametrize("goal", GOALS)
def test_select_for_goal_picks_the_reference_candidate(goal):
    rs, ts = _search(revo, "off"), _search(tevo, "off")
    rstate, tstate = rs.run(), ts.run()
    want, got = rs.select_for_goal(rstate, goal), ts.select_for_goal(tstate,
                                                                     goal)
    assert (want is None) == (got is None)
    if want is not None:
        assert got.phash == want.phash
        np.testing.assert_array_equal(got.cheap, want.cheap)
        np.testing.assert_array_equal(got.expensive, want.expensive)
    for objective in ("energy_max_alpha_j", "latency_min_alpha_s"):
        a, b = rs.select_solution(rstate, objective), \
            ts.select_solution(tstate, objective)
        assert (a is None and b is None) or a.phash == b.phash
    rf, tf = rs.pareto_fronts(rstate), ts.pareto_fronts(tstate)
    assert rf.keys() == tf.keys()
    for k in rf:
        np.testing.assert_array_equal(tf[k], rf[k])


@pytest.mark.parametrize("direction", ["repro_to_port", "port_to_repro"])
def test_checkpoint_resumes_across_packages(tmp_path, direction):
    """Two generations in one package, saved; resumed by the other to four:
    the same history and population as four uninterrupted generations."""
    first, second = (revo, tevo) if direction == "repro_to_port" \
        else (tevo, revo)
    ref = _search(revo, "off").run()
    path = str(tmp_path / "nas.json")
    s = _search(first, "off")
    state = s.init_state()
    for _ in range(2):
        state = s.step(state)
        s.save_state(state, path)
    final = _search(second, "off").run_resumable(path, generations=4)
    _assert_same_trajectory(final, ref)
    with open(path) as f:
        assert json.load(f)["generation"] == 4


# ------------------------------------------- tests/test_evolution.py, ported

def test_search_progresses_and_respects_capacity():
    calls = []
    s = _search(tevo, injected="scalar", calls=calls, population_cap=64)
    state = s.run()
    assert state.generation == 4 and len(state.history) == 4
    assert len(state.population) <= s.cfg.population_cap
    objs = np.stack([c.objective_vector() for c in state.population])
    assert len(pareto_front(objs)) >= 1
    # the dormant-gene cache: no phenotype is trained twice
    assert len(calls) == len(set(calls))
    assert set(calls) <= set(state.evaluated_hashes)


def test_async_pipeline_keeps_invariants():
    calls = []
    s = _search(tevo, "async", calls=calls, lookahead=2)
    state = s.run()
    assert state.generation == 4 and len(state.history) == 4
    assert all(r.get("pipeline") == "async" for r in state.history)
    assert len(set(state.pop.phash)) == len(state.pop)
    assert state.pop.trained_mask.all()
    assert len(calls) == len(set(calls))


def test_async_pipeline_checkpoints_at_drain_barriers(tmp_path):
    path = str(tmp_path / "ckpt.json")
    seen = []
    s = _search(tevo, "async", lookahead=1, ckpt_every=2)
    orig = s.save_state

    def spy(state, p):
        seen.append(state.generation)
        assert state.pop.trained_mask.all()
        orig(state, p)

    s.save_state = spy
    final = s.run_resumable(path)
    assert seen == [0, 2, 4] and final.generation == 4
    restored = _search(tevo, "async").load_state(path)
    assert list(restored.pop.phash) == list(final.pop.phash)


def test_history_records_timing_breakdown():
    state = _search(tevo, "off").run()
    for rec in state.history:
        assert set(rec["timings"]) == {"children", "cheap_score", "train",
                                       "select"}
        assert all(v >= 0.0 for v in rec["timings"].values())
        assert rec["train_jobs"] >= 0
    assert any(r["train_jobs"] > 0 and r["device_busy_s"]
               for r in state.history if r["trained"])


def test_dispatches_signature_buckets():
    from repro_torch.core.trainer_batch import shape_signature
    seen = []

    def batch(genomes, device=None):
        seen.append(genomes)
        return [_result(TrainResult, g) for g in genomes]

    s = tevo.EvolutionarySearch(
        tevo.NASConfig(generations=1, children_per_gen=6, n_accept=3,
                       init_population=5, n_workers=2, seed=0),
        None, None, batch_train_fn=batch, log=lambda *_: None, device="cpu")
    state = s.run()
    assert seen and state.pop.trained_mask.any()
    for genomes in seen:
        assert len({shape_signature(g) for g in genomes}) == 1


def test_failed_buckets_get_schema_pessimism():
    def explode(genomes, device=None):
        raise RuntimeError("bucket OOM")

    s = tevo.EvolutionarySearch(
        tevo.NASConfig(generations=1, children_per_gen=4, n_accept=2,
                       init_population=4, n_workers=2, seed=0),
        None, None, batch_train_fn=explode, log=lambda *_: None,
        device="cpu")
    s.scheduler.max_retries = 0
    state = s.init_state()
    worst = pessimistic_expensive(s.full_schema)
    np.testing.assert_array_equal(state.pop.expensive,
                                  np.tile(worst, (len(state.pop), 1)))


def test_search_is_bit_identical_under_crash_and_retry():
    ref = _search(tevo).run()
    plan = FaultPlan([crash_every(3)])
    faulted = _search(tevo, faults=plan).run()
    assert plan.fired("scheduler.job", kind="crash")
    _assert_same_trajectory(faulted, ref)
    # and equal to the reference's faulted run
    _assert_same_trajectory(
        faulted, _search(revo, faults=RFaultPlan([rcrash_every(3)])).run())


def test_nan_candidate_quarantined_bucket_mates_survive():
    ref = _search(tevo).init_state()
    plan = FaultPlan([nan_candidate_every(5, times=1)])
    lines = []
    s = _search(tevo, faults=plan, log=lambda *a: lines.append(
        " ".join(str(x) for x in a)))
    state = s.init_state()
    bad = plan.fired("trainer.result", kind="nonfinite")[0].ctx["phash"]
    assert any("diverged" in ln and "quarantined" in ln for ln in lines)
    for i, h in enumerate(state.pop.phash):
        want = s._exp_worst if str(h) == bad else ref.pop.expensive[i]
        np.testing.assert_array_equal(state.pop.expensive[i], want)
    np.testing.assert_array_equal(state.evaluated_hashes[bad], s._exp_worst)


def test_graceful_preemption_resumes_bit_identically(tmp_path):
    ref = _search(tevo).run_resumable(str(tmp_path / "ref.json"))
    path = str(tmp_path / "ckpt.json")
    plan = FaultPlan([FaultSpec(site="search.generation", kind="preempt",
                                when=lambda c: c["generation"] == 2,
                                times=1)])
    with pytest.raises(KeyboardInterrupt):
        _search(tevo, faults=plan).run_resumable(path)
    assert _search(tevo).load_state(path).generation == 2
    _assert_same_trajectory(_search(tevo).run_resumable(path), ref)


def test_checkpoint_corruption_falls_back_to_rotated_prev(tmp_path):
    path = str(tmp_path / "ckpt.json")
    plan = FaultPlan([FaultSpec(site="ckpt.save", kind="corrupt", at=(3,))])
    final = _search(tevo, generations=2, faults=plan).run_resumable(path)
    with pytest.raises(json.JSONDecodeError):
        with open(path) as f:
            json.load(f)
    assert _search(tevo, generations=2).load_state(path).generation == 1
    resumed = _search(tevo, generations=2).run_resumable(path)
    _assert_same_trajectory(final, resumed)


def test_checkpoint_schema_mismatch_raises(tmp_path):
    path = str(tmp_path / "ckpt.json")
    s = _search(tevo, generations=1)
    s.save_state(s.init_state(), path)
    other = _search(tevo, backends=["fpga_zu", "tpu_roofline"])
    with pytest.raises(ValueError, match="schema"):
        other.load_state(path)


def test_unknown_pipeline_mode_rejected():
    with pytest.raises(ValueError, match="pipeline"):
        tevo.EvolutionarySearch(tevo.NASConfig(pipeline="sometimes"), None,
                                None, train_fn=lambda g: None,
                                log=lambda *_: None, device="cpu")


def test_device_imbalance_helper():
    f = tevo.device_imbalance
    assert f({}) is None and f({"cpu:0": 5.0}) is None
    assert f({"cpu:0": 0.0, "cpu:1": 0.0}) is None
    assert abs(f({"cpu:0": 1.0, "cpu:1": 1.1}) - 1.1) < 1e-9
    assert f({"cpu:0": 0.0, "cpu:1": 3.0}) == float("inf")


# ------------------------------------------------------------ the device

def test_search_without_a_device_needs_the_card(monkeypatch):
    """No fallback: with no CUDA device, a search (and serve_winner) that
    is not told ``device="cpu"`` raises, as ``resolve_device`` does."""
    from repro_torch.serve import serve_winner
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tevo.EvolutionarySearch(tevo.NASConfig(), None, None)
    s = _search(tevo, generations=1, det_min=0.0, fa_max=1.0)
    state = s.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_winner(s, state, data_train=None, data_val=None)


def test_cpu_search_keeps_the_plain_thread_pool(monkeypatch):
    """A search on the CPU never pins workers to cards, whatever the host
    has; local_search_devices lists the cards, cut to max_devices."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert local_search_devices() == [torch.device("cuda", i)
                                      for i in range(3)]
    assert local_search_devices(2) == [torch.device("cuda", 0),
                                       torch.device("cuda", 1)]
    s = tevo.EvolutionarySearch(tevo.NASConfig(), None, None,
                                log=lambda *_: None, device="cpu")
    assert s.devices is None and s.device == torch.device("cpu")


# ------------------------------------------------------ the slice as a whole

def test_search_then_serve_winner_matches_reference(monkeypatch):
    """search -> select_for_goal -> serve_winner through both packages on
    the same records: the same winner, the same validation rates and
    compiled plan, and the same served classes.  Training is injected in
    the search (as above) and skipped for the winner (0 steps, both sides
    from ``repro``'s init): trained winners drift apart
    (tests/test_torch_ecg_serve.py says why).  The rates, the compiled
    plan and the served classes (no activation quant on the deployment
    path) are exact.  val_loss is held at 2**-7 relative: the winners
    quantize activations to 8 bits, and an activation that lands on a
    rounding boundary on one side only moves by one 8-bit step, 2**-7 of
    its layer's scale."""
    from repro.data.ecg import make_ecg_dataset, train_val_split
    from repro.serve import serve_winner as jserve_winner
    from repro_torch.serve import serve_winner
    from repro_torch.weights import candidate_params_from_jax
    from torch_parity import candidate_params

    tr, va = train_val_split(*make_ecg_dataset(seed=0, n_samples=48,
                                               decimation=16))
    rs, ts = _search(revo, "host_overlap"), _search(tevo, "host_overlap")
    rstate, tstate = rs.run(), ts.run()
    cand = rs.select_for_goal(rstate, "low_energy")
    jparams, tree = candidate_params(cand.genome.phenotype(rs.space),
                                     perturb=False)
    monkeypatch.setattr(rtrainer, "init_candidate", lambda rng, specs: jparams)
    monkeypatch.setattr("repro_torch.core.trainer.init_candidate",
                        lambda gen, specs, in_ch=2, device=None:
                        candidate_params_from_jax(tree, device))
    kw = dict(data_train=tr, data_val=va, train_steps=0, train_batch=16,
              replicas=2, log=lambda *_: None)
    want = jserve_winner(rs, rstate, "low_energy", **kw)
    got = serve_winner(ts, tstate, "low_energy", device="cpu", **kw)
    assert got.winner.genome == type(got.winner.genome)(
        **{k: getattr(want.winner.genome, k)
           for k in got.winner.genome.__dataclass_fields__})
    for k in ("detection_rate", "false_alarm_rate", "steps"):
        assert got.winner.train_meta[k] == want.winner.train_meta[k], k
    assert got.winner.genome.quant(ts.space).act_bits == 8
    np.testing.assert_allclose(got.winner.train_meta["val_loss"],
                               want.winner.train_meta["val_loss"],
                               rtol=2 ** -7, atol=0)
    assert got.winner.compiled.alphas == want.winner.compiled.alphas
    assert got.report().splitlines()[1:] == want.report().splitlines()[1:]
    np.testing.assert_array_equal(got.classify(va[0]),
                                  want.classify(va[0]))
