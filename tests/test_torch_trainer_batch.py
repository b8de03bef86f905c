"""The port's bucketed, stacked trainer (``core/trainer_batch.py``).

* Bucketing equals ``repro``'s on tests/test_trainer_batch.py's mixed
  population.
* Batched equals the port's own scalar ``train_candidate`` (the parity
  contract of DESIGN.md §9): identical expensive objectives and val_loss
  within 5e-3, the reference test's own bound.
* Batched equals ``repro``'s ``train_candidates_batched`` when both start
  from the same params (``repro``'s ``init_candidate``, copied in through
  the ``init_candidate`` seam, as tests/test_torch_ecg_train.py does).
  Tolerance: the rates exactly, val_loss within 1e-3 absolute.  One
  carried step holds every leaf within 1e-4 between the packages
  (tests/test_torch_ecg_train.py); four steps compound that, and the
  loss is an average over 48 records, so 1e-3 is ten times the per-step
  leaf bound.  The genomes quantize weights to 8 bits and activations to
  16, so that an activation that lands on a rounding boundary on one side
  only moves by a 16-bit step.
"""
import numpy as np
import pytest
import torch

import repro.core.trainer_batch as rtb
from repro.core.genome import Genome as RGenome
from repro.core.search_space import SearchSpace as RSpace
from repro_torch.core import trainer as tt
from repro_torch.core import trainer_batch as ttb
from repro_torch.core.genome import Genome
from repro_torch.core.objectives import expensive_objectives
from repro_torch.core.search_space import SearchSpace
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_map
from repro_torch.weights import candidate_params_from_jax
from torch_parity import candidate_params, one_thread  # noqa: F401

# coarse decimation => 250-sample inputs: training stays test-sized
SPACE, RSPACE = SearchSpace(input_decimations=(240,)), \
    RSpace(input_decimations=(240,))
CONV_C8_K3_S2, CONV_C4_K5_S4, CONV_C16_K1_S1, POOL_S2 = 28, 20, 36, 60


def chain_genes(op_ids, quant=(0, 0, 0), dec=0) -> dict:
    """The genes of a plain chain expressing exactly ``op_ids``."""
    d = SPACE.max_depth
    return dict(op_genes=tuple(op_ids) + (0,) * (d - len(op_ids)),
                conn_genes=tuple(range(d)), out_gene=len(op_ids),
                w_bits_gene=quant[0], a_bits_gene=quant[1],
                i_bits_gene=quant[2], dec_gene=dec)


MIXED = ([chain_genes((CONV_C8_K3_S2, CONV_C4_K5_S4), q)
          for q in ((0, 0, 0), (1, 1, 1), (0, 1, 0))]
         + [chain_genes((CONV_C16_K1_S1, POOL_S2), q)
            for q in ((1, 0, 1), (0, 0, 1))]
         + [chain_genes((POOL_S2, CONV_C8_K3_S2))])


def mixed_population():
    """Two signature buckets (3 + 2 members, quant variants inside each)
    plus a singleton that takes the scalar path."""
    return [Genome(**g) for g in MIXED]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    x_tr = rng.normal(size=(64, 250, 2)).astype(np.float32)
    x_va = rng.normal(size=(48, 250, 2)).astype(np.float32)
    y_tr = (np.arange(64) % 2).astype(np.int32)
    y_va = (np.arange(48) % 2).astype(np.int32)
    return (x_tr, y_tr), (x_va, y_va)


def test_buckets_equal_the_reference():
    pop, rpop = mixed_population(), [RGenome(**g) for g in MIXED]
    assert [ttb.shape_signature(g, SPACE) for g in pop] == \
        [rtb.shape_signature(g, RSPACE) for g in rpop]
    assert ttb.bucket_by_signature(pop, SPACE) == \
        rtb.bucket_by_signature(rpop, RSPACE)
    assert ttb.bucket_by_signature(pop, SPACE, use_quant=False) == \
        rtb.bucket_by_signature(rpop, RSPACE, use_quant=False)
    sizes = sorted(map(len, ttb.bucket_by_signature(pop, SPACE).values()))
    assert sizes == [1, 2, 3]


@pytest.mark.parametrize("seeds", [None, [3, 4, 5, 6, 7, 8]],
                         ids=["one_seed", "per_candidate_seeds"])
def test_batched_matches_scalar(data, seeds):
    tr, va = data
    pop = mixed_population()
    kw = dict(space=SPACE, steps=12, batch_size=16, lr=3e-3)
    per = seeds or [0] * len(pop)
    scalar = [tt.train_candidate(g, tr, va, seed=s, device="cpu", **kw)
              for g, s in zip(pop, per)]
    batched = ttb.train_candidates_batched(pop, tr, va, seeds=seeds,
                                           device="cpu", **kw)
    assert len(batched) == len(pop)
    for s, b in zip(scalar, batched):
        np.testing.assert_array_equal(expensive_objectives(s),
                                      expensive_objectives(b))
        assert b.steps == s.steps and abs(s.val_loss - b.val_loss) < 5e-3


def test_stacked_step_is_the_scalar_step(data):
    """One vmapped step against ``train_step_pure`` per candidate, from
    the same params and AdamW state: each candidate's clip norm is its
    own, so a bucket-mate with a much larger gradient changes nothing."""
    (x, y), _ = data
    g = mixed_population()[0]
    specs = g.phenotype(SPACE)
    quants = [Genome(**q).quant(SPACE) for q in MIXED[:3]]
    per = [tt.init_candidate(torch.Generator().manual_seed(s), specs,
                             device="cpu") for s in (0, 1, 2)]
    per[2] = tree_map(lambda t: t * 40.0, per[2])
    opt = adamw(3e-3, b1=0.9, b2=0.99, weight_decay=1e-4)
    idx = np.random.default_rng(0).integers(0, len(x), (3, 16))
    xb, yb = torch.from_numpy(x[idx]), torch.from_numpy(y[idx]).long()
    sig = ttb.shape_signature(g, SPACE)
    step, _ = ttb._build_bucket_step(specs, True, opt)
    stacked = tree_map(lambda *t: torch.stack(t), *per)
    bits = torch.tensor([[q.weight_bits, q.act_bits, q.input_bits]
                         for q in quants], dtype=torch.int32)
    got, _, loss = step(stacked, opt.init(stacked), xb, yb, bits)
    assert sig[2] and loss.shape == (3,)
    for k in range(3):
        want, _, wloss = tt.train_step_pure(
            per[k], opt.init(per[k]), xb[k], yb[k], specs=specs,
            quant=quants[k], opt=opt)
        assert torch.allclose(loss[k], wloss, rtol=1e-6, atol=1e-7)
        for i, (wp, gp) in enumerate(zip(want, tree_map(lambda t: t[k],
                                                         got))):
            for name in wp:
                # a conv bias before a train-mode BN has an exact gradient
                # of 0; its computed one is rounding noise, and AdamW's
                # first step moves it by +-lr with the noise's sign
                # (tests/test_torch_ecg_train.py holds it the same way)
                tol = dict(rtol=0, atol=2 * 3e-3) if name == "b" \
                    and specs[i].kind == "dwsep_conv" else \
                    dict(rtol=1e-5, atol=1e-6)
                torch.testing.assert_close(gp[name], wp[name], **tol)


def test_cache_hits_across_generations(data):
    tr, va = data
    pop = mixed_population()
    kw = dict(space=SPACE, steps=2, batch_size=8, lr=3e-3, seed=0,
              device="cpu")
    ttb.reset_compile_cache()
    ttb.train_candidates_batched(pop, tr, va, **kw)
    assert ttb.compile_cache_stats() == {"hits": 0, "misses": 2, "size": 2}
    ttb.train_candidates_batched(pop, tr, va, **kw)
    assert ttb.compile_cache_stats() == {"hits": 2, "misses": 2, "size": 2}
    ttb.train_candidates_batched(pop, tr, va, **{**kw, "steps": 3})
    assert ttb.compile_cache_stats() == {"hits": 2, "misses": 4, "size": 4}
    ttb.reset_compile_cache()
    assert ttb.compile_cache_stats() == {"hits": 0, "misses": 0, "size": 0}


def test_stage_cache_keys_the_device(data):
    tr, va = data
    cache = {}
    ttb.train_candidates_batched(mixed_population()[:3], tr, va, space=SPACE,
                                 steps=2, batch_size=8, stage_cache=cache,
                                 device="cpu")
    assert list(cache) == [(250, torch.device("cpu"))]


def test_one_diverged_candidate_is_quarantined(data, monkeypatch):
    """A candidate whose params start non-finite reports det 0 / fa 1 and a
    non-finite val_loss; its bucket-mates keep a clean run's results."""
    tr, va = data
    pop = mixed_population()[:3]
    kw = dict(space=SPACE, steps=3, batch_size=8, seeds=[0, 1, 2],
              device="cpu")
    clean = ttb.train_candidates_batched(pop, tr, va, **kw)
    init = tt.init_candidate

    def poisoned(gen, specs, in_ch=2, *, device=None):
        params = init(gen, specs, in_ch, device=device)
        if gen.initial_seed() == 1:
            params[0]["pw"] = params[0]["pw"] * float("inf")
        return params
    monkeypatch.setattr(ttb, "init_candidate", poisoned)
    got = ttb.train_candidates_batched(pop, tr, va, **kw)
    assert (got[1].detection_rate, got[1].false_alarm_rate) == (0.0, 1.0)
    assert not np.isfinite(got[1].val_loss)
    for k in (0, 2):
        assert got[k] == clean[k]


def test_seeds_must_align():
    with pytest.raises(ValueError):
        ttb.train_candidates_batched(mixed_population(), None, None,
                                     space=SPACE, seeds=[0])


def test_no_device_means_the_card(data, monkeypatch):
    tr, va = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttb.train_candidates_batched(mixed_population()[:2], tr, va,
                                     space=SPACE, steps=1)


@pytest.fixture
def reference_cache():
    """``repro``'s compile cache, emptied around a test that patches its
    init (a cached trace would keep the real one)."""
    rtb.reset_compile_cache()
    yield
    rtb.reset_compile_cache()


def test_batched_matches_the_reference_from_the_same_params(
        data, monkeypatch, reference_cache):
    tr, va = data
    genes = [chain_genes((CONV_C8_K3_S2, CONV_C4_K5_S4), q)
             for q in ((1, 1, 1), (1, 1, 0))]
    rpop, pop = [RGenome(**g) for g in genes], [Genome(**g) for g in genes]
    jparams, tree = candidate_params(rpop[0].phenotype(RSPACE), seed=2)
    monkeypatch.setattr(rtb, "init_candidate", lambda rng, specs: jparams)
    monkeypatch.setattr(ttb, "init_candidate",
                        lambda gen, specs, in_ch=2, device=None:
                        candidate_params_from_jax(tree, device))
    kw = dict(steps=4, batch_size=16, lr=3e-3, seeds=[0, 1])
    want = rtb.train_candidates_batched(rpop, tr, va, space=RSPACE, **kw)
    got = ttb.train_candidates_batched(pop, tr, va, space=SPACE,
                                       device="cpu", **kw)
    for w, g in zip(want, got):
        assert (g.detection_rate, g.false_alarm_rate, g.steps) == \
            (w.detection_rate, w.false_alarm_rate, w.steps)
        np.testing.assert_allclose(g.val_loss, w.val_loss, rtol=0,
                                   atol=1e-3)
