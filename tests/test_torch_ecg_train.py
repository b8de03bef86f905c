"""The port's optimizer, trainer, profiler and compiler (optim/adamw.py,
core/trainer.py, hwlib/profiler.py, core/compile_model.py) against
``repro`` on the same numpy inputs (CPU).

Both sides start from the same params: ``repro``'s ``init_candidate``
copied into the port with ``candidate_params_from_jax`` (JAX's threefry
init cannot be replayed in torch), with biases and BN params moved off
their init values.  Tolerances, and why:

* f32 1e-5 where both sides run the same f32 arithmetic in other orders.
* 1e-4 where the genome's 16-bit activation fake-quant is on: a 16-bit
  step is max/32767, about two f32 ulps of the largest activation, so the
  two sides' rounding differences flip single activations by one step;
  each flip moves a value by ~3e-5 of the layer's max.
* Training steps are held one at a time from carried params (both sides
  start each step from ``repro``'s params and optimizer state).  Adam
  divides by sqrt(v_hat): at the first step its update is -lr * sign(g)
  for any gradient much above eps, so a gradient that is rounding noise
  on both sides (the conv bias before a train-mode BN has an exact
  gradient of 0) moves by +-lr with the noise's sign.  Those biases are
  held at 2 * lr, and their gradients at 1e-6 absolute.  Every other
  leaf's gradient is held normwise at 1e-3 of its norm before AdamW (the
  two sides differ by at most 2e-5 of it on these inputs, with the 16-bit
  activation quant on or off), and the leaf after the step at 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compile_model as jcompile
from repro.core import trainer as jt
from repro.hwlib import profiler as jprof
from repro.hwlib.quant import QuantConfig as JQuant
from repro.optim import adamw as jadamw
from repro.optim import clip_by_global_norm as jclip
from repro_torch.core import compile_model as tcompile
from repro_torch.core import trainer as tt
from repro_torch.hwlib import profiler as tprof
from repro_torch.hwlib.quant import QuantConfig as TQuant
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import apply_updates, clip_by_global_norm
from repro_torch.optim.adamw import AdamWState, tree_leaves
from repro_torch.weights import candidate_params_from_jax
from torch_parity import (F32_TOL, NARROW_GENES, WIDE_GENES,  # noqa: F401
                          candidate_params, genomes, np_of, one_thread)

QUANT_TOL = dict(rtol=1e-4, atol=1e-4)
LR = 3e-3


@pytest.fixture(scope="module")
def narrow():
    """Narrow genome, its specs and shared params, and 24 records at its
    input length (1875)."""
    jg, tg = genomes(NARROW_GENES)
    jparams, tree = candidate_params(jg.phenotype())
    rng = np.random.default_rng(0)
    x = rng.normal(size=(24, 1875, 2)).astype(np.float32)
    y = (np.arange(24) % 2).astype(np.int32)
    return jg, tg, jparams, tree, x, y


def _port(tree):
    return candidate_params_from_jax(tree, "cpu")


def _close_tree(got, want, **tol):
    for gp, wp in zip(got, want):
        assert sorted(gp) == sorted(wp)
        for k in gp:
            np.testing.assert_allclose(np_of(gp[k]), np.asarray(wp[k]),
                                       err_msg=k, **tol)


def test_adamw_step_term_for_term():
    """Three steps fed the same grads on both sides, with a schedule."""
    rng = np.random.default_rng(1)
    params = [{"w": rng.normal(size=(5, 3)).astype(np.float32),
               "b": rng.normal(size=(3,)).astype(np.float32)}, {}]
    sched = lambda step: 3e-3 / step        # noqa: E731
    jopt = jadamw(sched, b1=0.9, b2=0.99, weight_decay=1e-4)
    topt = tadamw(sched, b1=0.9, b2=0.99, weight_decay=1e-4)
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    tp = _port(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        g = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p.items()} for p in params]
        ju, js = jopt.update([{k: jnp.asarray(v) for k, v in p.items()}
                              for p in g], js, jp)
        tu, ts = topt.update(_port(g), ts, tp)
        _close_tree(tu, ju, rtol=1e-6, atol=1e-9)
        _close_tree(ts.m, js.m, rtol=1e-6, atol=1e-9)
        _close_tree(ts.v, js.v, rtol=1e-6, atol=1e-9)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tp = apply_updates(tp, tu)
        _close_tree(tp, jp, rtol=1e-6, atol=1e-8)
    assert ts.step == int(js.step) == 3


def test_clip_by_global_norm():
    rng = np.random.default_rng(2)
    g = [{"a": rng.normal(size=(4, 4)).astype(np.float32)},
         {"b": rng.normal(size=(7,)).astype(np.float32)}]
    for max_norm in (1.0, 100.0):
        jg, jn = jclip([{k: jnp.asarray(v) for k, v in p.items()}
                        for p in g], max_norm)
        tg, tn = clip_by_global_norm(_port(g), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _close_tree(tg, jg, rtol=1e-6, atol=1e-9)
    assert [t.shape for t in tree_leaves(tg)] == [(4, 4), (7,)]


@pytest.mark.parametrize("quant", [None, "genome"])
@pytest.mark.parametrize("train", [False, True])
def test_forward(narrow, quant, train):
    jg, tg, jparams, tree, x, _ = narrow
    jq = jg.quant() if quant else None
    tq = tg.quant() if quant else None
    want = jt.forward(jparams, jg.phenotype(), jnp.asarray(x[:8]), jq,
                      train=train)
    with torch.set_grad_enabled(train):
        got = tt.forward(_port(tree), tg.phenotype(),
                         torch.from_numpy(x[:8]), tq, train=train)
    np.testing.assert_allclose(np_of(got), np.asarray(want),
                               **(QUANT_TOL if quant else F32_TOL))


@pytest.mark.parametrize("quant", [None, "genome"])
def test_refresh_bn_pure(narrow, quant):
    """Pre-BN product from the quantized weights, stats into the
    unquantized dict (the reference's order), on a calibration batch."""
    jg, tg, jparams, tree, x, _ = narrow
    jq = jg.quant() if quant else None
    tq = tg.quant() if quant else None
    want = jt.refresh_bn_stats(jparams, jg.phenotype(), jnp.asarray(x), jq)
    got = tt.refresh_bn_stats(_port(tree), tg.phenotype(),
                              torch.from_numpy(x), tq)
    _close_tree(got, want, **(QUANT_TOL if quant else F32_TOL))
    with torch.no_grad():
        pure = tt.refresh_bn_pure(_port(tree), tg.phenotype(),
                                  torch.from_numpy(x), tq)
    _close_tree(pure, [{k: np_of(v) for k, v in p.items()} for p in got],
                rtol=0, atol=0)


def test_loss_and_grads_without_quant(narrow):
    jg, tg, jparams, tree, x, y = narrow
    loss, grads = jax.value_and_grad(jt._loss_fn)(
        jparams, jg.phenotype(), None, jnp.asarray(x[:16]),
        jnp.asarray(y[:16]))
    live = [{k: v.requires_grad_(True) for k, v in p.items()}
            for p in _port(tree)]
    got = tt._loss_fn(live, tg.phenotype(), None, torch.from_numpy(x[:16]),
                      torch.from_numpy(y[:16]).long())
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-6)
    for lp, gp in zip(live, grads):
        for k, g in gp.items():
            mine = lp[k].grad if lp[k].grad is not None \
                else torch.zeros_like(lp[k])
            np.testing.assert_allclose(np_of(mine), np.asarray(g),
                                       rtol=1e-4, atol=1e-6, err_msg=k)


def _pre_bn_bias(specs, i, k):
    return k == "b" and specs[i].kind == "dwsep_conv" and specs[i].use_bn


def _close_grads(live, grads, specs, where):
    """Each leaf's autograd gradient against ``jax.grad``'s, normwise
    (see the module docstring); ``None`` counts as zero."""
    for i, (lp, gp) in enumerate(zip(live, grads)):
        for k, g in gp.items():
            want = np.asarray(g)
            got = np_of(lp[k].grad) if lp[k].grad is not None \
                else np.zeros_like(want)
            msg = f"{where} layer {i} {k}"
            if _pre_bn_bias(specs, i, k):
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                           err_msg=msg)
                continue
            err = np.linalg.norm(got - want)
            assert err <= 1e-3 * np.linalg.norm(want), (msg, err)


@pytest.mark.parametrize("quant", [(8, 0, 0), (8, 16, 16)],
                         ids=["weights_only", "w8a16i16"])
def test_train_steps_from_carried_params(narrow, quant):
    """Four steps on the presampled minibatches of seed 0; each starts both
    sides from ``repro``'s params and AdamW state.  The gradients before
    clipping and AdamW are held against ``jax.grad`` of the reference's
    loss, then the stepped params."""
    jg, tg, jparams, tree, x, y = narrow
    jq, tq = JQuant(*quant), TQuant(*quant)
    specs = tg.phenotype()
    opt_j = jadamw(LR, b1=0.9, b2=0.99, weight_decay=1e-4)
    opt_t = tadamw(LR, b1=0.9, b2=0.99, weight_decay=1e-4)
    jstate = opt_j.init(jparams)
    idx, _ = tt.presample_indices(0, len(x), 4, 8)
    for s in range(4):
        as_np = jax.tree.map(np.asarray, (jparams, jstate.m, jstate.v))
        grads = jax.grad(jt._loss_fn)(
            jparams, jg.phenotype(), jq, jnp.asarray(x[idx[s]]),
            jnp.asarray(y[idx[s]]))
        live = [{k: v.requires_grad_(True) for k, v in p.items()}
                for p in _port(as_np[0])]
        tt._loss_fn(live, specs, tq, torch.from_numpy(x[idx[s]]),
                    torch.from_numpy(y[idx[s]]).long()).backward()
        _close_grads(live, grads, specs, f"step {s}")
        tstate = AdamWState(step=int(jstate.step), m=_port(as_np[1]),
                            v=_port(as_np[2]))
        tp, _, tloss = tt.train_step_pure(
            _port(as_np[0]), tstate, torch.from_numpy(x[idx[s]]),
            torch.from_numpy(y[idx[s]]).long(), specs=specs, quant=tq,
            opt=opt_t)
        jparams, jstate, jloss = jt.train_step_pure(
            jparams, jstate, jnp.asarray(x[idx[s]]), jnp.asarray(y[idx[s]]),
            specs=jg.phenotype(), quant=jq, opt=opt_j)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5,
                                   atol=1e-5)
        for i, (gp, wp) in enumerate(zip(tp, jparams)):
            for k in gp:
                tol = dict(rtol=0, atol=2 * LR) if \
                    _pre_bn_bias(specs, i, k) else dict(rtol=1e-4, atol=1e-4)
                np.testing.assert_allclose(np_of(gp[k]), np.asarray(wp[k]),
                                           err_msg=f"step {s} layer {i} {k}",
                                           **tol)


def test_presample_indices_detection_rates_prep_inputs():
    for a, b in zip(tt.presample_indices(7, 100, 5, 8, calib_size=30),
                    jt.presample_indices(7, 100, 5, 8, calib_size=30)):
        assert np.array_equal(a, b)
    rng = np.random.default_rng(0)
    pred, y = rng.integers(0, 2, 50), rng.integers(0, 2, 50)
    assert tt.detection_rates(pred, y) == jt.detection_rates(pred, y)
    assert tt.detection_rates(pred, np.zeros(50)) == \
        jt.detection_rates(pred, np.zeros(50))
    x = rng.normal(size=(3, 3750, 2)).astype(np.float32)
    assert np.array_equal(tt.prep_inputs(x, 1875), jt.prep_inputs(x, 1875))
    assert tt.prep_inputs(x, 3750) is x


def test_evaluate_quantizes_per_chunk(narrow):
    """300 records: two chunks of 256 and 44, each with its own input
    fake-quant scale, as in the reference."""
    jg, tg, jparams, tree, _, _ = narrow
    rng = np.random.default_rng(4)
    x = rng.normal(size=(300, 1875, 2)).astype(np.float32)
    x[256:] *= 3.0                   # the second chunk's scale differs
    y = rng.integers(0, 2, 300).astype(np.int32)
    det, fa, nll = tt.evaluate(_port(tree), tg.phenotype(), tg.quant(), x, y,
                               device="cpu")
    jdet, jfa, jnll = jt.evaluate(jparams, jg.phenotype(), jg.quant(), x, y)
    assert (det, fa) == (jdet, jfa)
    np.testing.assert_allclose(nll, jnll, rtol=1e-5)


def test_profile_accumulators_and_report(narrow):
    jg, tg, jparams, tree, x, _ = narrow
    got = tprof.profile_accumulators(_port(tree), tg.phenotype(),
                                     torch.from_numpy(x))
    want = jprof.profile_accumulators(jparams, jg.phenotype(),
                                      jnp.asarray(x))
    assert [dataclasses.astuple(f) for f in got] == \
        [dataclasses.astuple(f) for f in want]
    assert tprof.accumulator_report(got, tg.phenotype()) == \
        jprof.accumulator_report(want, jg.phenotype())


@pytest.mark.parametrize("genes", ["narrow", "wide"])
def test_compile_candidate(narrow, genes):
    """Fold, quantize, profile: alphas, formats and estimates equal;
    compiled params at f32 tolerance (no activation quant on this path)."""
    if genes == "narrow":
        jg, tg, jparams, tree, x, _ = narrow
    else:
        jg, tg = genomes(WIDE_GENES)
        jparams, tree = candidate_params(jg.phenotype(), seed=1)
        x = np.random.default_rng(1).normal(size=(4, 3750, 2)
                                            ).astype(np.float32)
    got = tcompile.compile_candidate(tg, _port(tree), torch.from_numpy(x))
    want = jcompile.compile_candidate(jg, jparams, jnp.asarray(x))
    assert got.alphas == want.alphas
    assert [dataclasses.astuple(f) for f in got.acc_formats] == \
        [dataclasses.astuple(f) for f in want.acc_formats]
    assert dataclasses.asdict(got.estimate_min) == \
        dataclasses.asdict(want.estimate_min)
    assert dataclasses.asdict(got.estimate_max) == \
        dataclasses.asdict(want.estimate_max)
    assert [s.short() for s in got.specs] == [s.short() for s in want.specs]
    _close_tree(got.params, want.params, **F32_TOL)
    assert got.report() == want.report()


def test_train_candidate_untrained_matches(narrow, monkeypatch):
    """``train_candidate`` with zero steps (BN re-estimation and evaluation
    only) from the reference's init: the same TrainResult."""
    jg, tg, jparams, tree, x, y = narrow
    monkeypatch.setattr(tt, "init_candidate",
                        lambda gen, specs, in_ch=2, device=None:
                        candidate_params_from_jax(tree, device))
    monkeypatch.setattr(jt, "init_candidate", lambda rng, specs: jparams)
    data = (x[:16], y[:16]), (x[16:], y[16:])
    got = tt.train_candidate(tg, *data, steps=0, device="cpu")
    want = jt.train_candidate(jg, *data, steps=0)
    assert (got.detection_rate, got.false_alarm_rate, got.steps) == \
        (want.detection_rate, want.false_alarm_rate, want.steps)
    np.testing.assert_allclose(got.val_loss, want.val_loss, **QUANT_TOL)
    assert got.meets_constraints(0.0, 1.0) == want.meets_constraints(0.0, 1.0)


def test_train_candidate_learns(narrow):
    """The port's own training loop on its own: 30 steps on separable data
    from a seeded torch init lower the validation loss."""
    _, tg, _, _, _, _ = narrow
    rng = np.random.default_rng(6)
    y = (np.arange(64) % 2).astype(np.int32)
    x = rng.normal(size=(64, 1875, 2)).astype(np.float32) * 0.1
    x[y == 1] += np.sin(np.linspace(0, 60, 1875))[None, :, None]
    data = (x[:48], y[:48]), (x[48:], y[48:])
    before = tt.train_candidate(tg, *data, steps=0, batch_size=16,
                                device="cpu")
    after = tt.train_candidate(tg, *data, steps=30, batch_size=16,
                               device="cpu")
    assert after.val_loss < before.val_loss
    assert after.detection_rate >= 0.5
