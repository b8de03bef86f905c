"""The port's genome front-end (serve/winner.py) against ``repro``'s
(CPU): ``compile_winner``, ``ServableWinner`` and ``ReplicatedWinner``
with an injected crash.

Both sides start from ``repro``'s init (copied into the port) and are
compiled with zero training steps, so what is compared is BN
re-estimation, evaluation, compilation and serving, at the tolerance of
the genome's 16-bit activation fake-quant (1e-4: a 16-bit step is about
two f32 ulps of the layer's max, so single activations can flip by one
step during BN re-estimation).  Training is held step by step in
tests/test_torch_ecg_train.py: two training runs of many steps drift
apart (Adam turns rounding noise in near-zero gradients into +-lr steps,
and weight fake-quant turns small weight differences into whole quant
steps), so trained winners are compared on what the port guarantees on
its own: the replicas answer exactly as the single winner does.
"""
import numpy as np
import pytest
import torch

from repro.core import trainer as jt
from repro.core.faults import FaultPlan as JFaultPlan
from repro.core.faults import FaultSpec as JFaultSpec
from repro.serve import winner as jw
from repro_torch.core import trainer as tt
from repro_torch.core.faults import FaultPlan, FaultSpec
from repro_torch.serve import (ReplicatedWinner, ServableWinner,
                               compile_winner, replicate_winner)
from repro_torch.weights import candidate_params_from_jax
from torch_parity import (  # noqa: F401 (one_thread: a fixture)
    NARROW_GENES,
    candidate_params,
    genomes,
    np_of,
    one_thread,
)

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def winners(tiny_ecg):
    """(port winner, reference winner, train split, val split): the narrow
    genome compiled by each package from the same init, 0 steps."""
    tr, va = tiny_ecg
    jg, tg = genomes(NARROW_GENES)
    jparams, tree = candidate_params(jg.phenotype(), perturb=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tt, "init_candidate",
                   lambda gen, specs, in_ch=2, device=None:
                   candidate_params_from_jax(tree, device))
        mp.setattr(jt, "init_candidate", lambda rng, specs: jparams)
        got = compile_winner(tg, tr, va, train_steps=0, train_batch=32,
                             goal="test", device="cpu")
        want = jw.compile_winner(jg, tr, va, train_steps=0, train_batch=32,
                                 goal="test")
    return got, want, tr, va


def test_compile_winner_matches(winners):
    got, want, _, _ = winners
    assert isinstance(got, ServableWinner)
    assert got.input_length == want.input_length == 1875
    for k in ("detection_rate", "false_alarm_rate", "steps"):
        assert got.train_meta[k] == want.train_meta[k], k
    np.testing.assert_allclose(got.train_meta["val_loss"],
                               want.train_meta["val_loss"], **TOL)
    assert got.compiled.alphas == want.compiled.alphas
    assert got.compiled.acc_formats == [type(got.compiled.acc_formats[0])(
        f.int_bits, f.frac_bits) for f in want.compiled.acc_formats]
    for gp, wp in zip(got.compiled.params, want.compiled.params):
        assert sorted(gp) == sorted(wp)
        for k in gp:
            np.testing.assert_allclose(np_of(gp[k]), np.asarray(wp[k]), **TOL)
    assert got.report() == want.report()


@pytest.mark.parametrize("n", [1, 5, 16])
def test_servable_winner_predict_and_classify(winners, n):
    """Batches padded to a power of two; logits and classes as the
    reference's.  Inputs at the dataset's resolution are decimated."""
    got, want, _, va = winners
    x = va[0][:n]
    before = got.batches_served
    logits = got.predict(x)
    assert logits.shape == (n, 2) and np.isfinite(logits).all()
    np.testing.assert_allclose(logits, want.predict(x), **TOL)
    assert np.array_equal(got.classify(x), want.classify(x))
    assert got.batches_served == before + 2
    wide = np.repeat(x, 2, axis=1)                 # (n, 3750, 2)
    assert np.array_equal(got.predict(wide), logits)


def test_replicated_winner_round_robin_and_failover(winners):
    """Round-robin replicas return the single winner's logits exactly; a
    replica that always crashes fails over mid-call and is quarantined,
    with the reference's dispatch statistics."""
    got, want, _, va = winners
    x = va[0][:10]
    ref = got.predict(x)
    rw = replicate_winner(got, 2)
    assert isinstance(rw, ReplicatedWinner)
    assert np.array_equal(rw.predict(x), ref)
    assert np.array_equal(rw.predict(x), ref)
    assert [r.batches_served for r in rw.replicas] == [1, 1]
    assert rw.replicas[0].predict.args[0] is got.compiled.params
    plans = (FaultPlan([FaultSpec(site="router.dispatch", kind="crash",
                                  when=lambda c: c["replica"] == 0)]),
             JFaultPlan([JFaultSpec(site="router.dispatch", kind="crash",
                                    when=lambda c: c["replica"] == 0)]))
    rw2 = replicate_winner(got, 2, faults=plans[0])
    jrw2 = jw.replicate_winner(want, 2, faults=plans[1])
    for _ in range(8):
        logits = rw2.predict(x)
        assert np.array_equal(logits, ref)
        assert np.array_equal(logits.argmax(1), jrw2.classify(x))
    assert rw2.stats == jrw2.stats
    assert rw2.stats["quarantined"] == [0] and rw2.live_replicas == [1]
    assert rw2.report().startswith("replicas=1/2 live")
    with pytest.raises(ValueError, match="at least one replica"):
        replicate_winner(got, 0)


def test_replicated_winner_one_crash_and_device_list(winners):
    """One crash at the first dispatch (the phase-9 plan): one failover,
    the same classes; replicas pinned to a device list hold params on that
    device."""
    got, _, _, va = winners
    x = va[0][:7]
    rw = replicate_winner(got, 2, devices=["cpu", "cpu"], faults=FaultPlan(
        [FaultSpec(site="router.dispatch", kind="crash", at=(1,))]))
    assert np.array_equal(rw.classify(x), got.classify(x))
    assert rw.stats["failovers"] == 1 and rw.stats["quarantined"] == []
    assert all(r.device == torch.device("cpu") for r in rw.replicas)
    everyone = FaultPlan([FaultSpec(site="router.dispatch", kind="crash",
                                    every=1)])
    with pytest.raises(RuntimeError, match="every live replica failed"):
        replicate_winner(got, 2, faults=everyone).predict(x)


def test_trained_winner_serves_and_replicas_agree(tiny_ecg):
    """A few real training steps on the port's own seeded init: finite
    rates, and a replicated winner that answers as the single one."""
    tr, va = tiny_ecg
    _, tg = genomes(NARROW_GENES)
    w = compile_winner(tg, tr, va, train_steps=8, train_batch=16, seed=1,
                       device="cpu")
    assert all(np.isfinite(w.train_meta[k]) for k in
               ("detection_rate", "false_alarm_rate", "val_loss"))
    x = va[0][:9]
    assert np.array_equal(replicate_winner(w, 3).predict(x), w.predict(x))


def test_compile_winner_without_a_card_raises(tiny_ecg, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tg = genomes(NARROW_GENES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_winner(tg, *tiny_ecg, train_steps=0)
