"""The port's copies of ``core/cost_backend.py`` and ``core/objectives.py``
against ``repro``'s, bit for bit (both are numpy), on seeded
``random_population``s; and inside the port, the scalar path against the
batched one (DESIGN.md §7) and ``PopulationArrays``' round trips."""
import dataclasses

import numpy as np
import pytest

from repro.core import cost_backend as rcb
from repro.core import genome as rgen
from repro.core import objectives as robj
from repro.core import trainer as rtrainer
from repro_torch.core import cost_backend as tcb
from repro_torch.core import genome as tgen
from repro_torch.core import objectives as tobj
from repro_torch.core.hw_model import FPGA_ZCU102, FPGA_ZU, PROFILES
from repro_torch.core.search_space import DEFAULT_SPACE
from repro_torch.core.trainer import TrainResult

N = 120
# every single-platform spec, and two composites
SPECS = sorted(PROFILES) + ["tpu_roofline", ("fpga_zu", "tpu_roofline"),
                            ("fpga_zcu102", "fpga_zu", "tpu_roofline")]
SPEC_IDS = ["+".join(s) if isinstance(s, tuple) else s for s in SPECS]


def _spec(spec):
    return list(spec) if isinstance(spec, tuple) else spec


@pytest.fixture(scope="module", params=[0, 5])
def pops(request):
    """(repro encoding, port encoding) drawn from one seed on each side."""
    renc = rgen.random_population(np.random.default_rng(request.param), N,
                                  rgen.DEFAULT_SPACE)
    tenc = tgen.random_population(np.random.default_rng(request.param), N,
                                  DEFAULT_SPACE)
    return renc, tenc


def test_random_populations_are_the_same_genomes(pops):
    renc, tenc = pops
    assert [dataclasses.astuple(g) for g in renc.to_genomes()] == \
        [dataclasses.astuple(g) for g in tenc.to_genomes()]
    assert renc.batch_phenotype_hash(rgen.DEFAULT_SPACE) == \
        tenc.batch_phenotype_hash(DEFAULT_SPACE)


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_backends_match_reference(pops, spec):
    renc, tenc = pops
    rbe, tbe = rcb.get_backend(_spec(spec)), tcb.get_backend(_spec(spec))
    assert type(tbe).__name__ == type(rbe).__name__ and tbe.name == rbe.name
    np.testing.assert_array_equal(tbe.evaluate_batch(tenc),
                                  rbe.evaluate_batch(renc))
    assert tcb.backend_schema(tbe).to_json() == \
        rcb.backend_schema(rbe).to_json()


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_scalar_evaluate_equals_batch(pops, spec):
    """DESIGN.md §7 inside the port: one genome scored alone gives its row
    of the batched matrix exactly."""
    _, tenc = pops
    be = tcb.get_backend(_spec(spec))
    batch = be.evaluate_batch(tenc)
    for i in range(0, N, 11):
        np.testing.assert_array_equal(be.evaluate(tenc.genome(i)), batch[i])


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_cheap_objectives_batch_matches_reference(pops, profile):
    renc, tenc = pops
    got = tobj.cheap_objectives_batch(tenc, profile=PROFILES[profile])
    np.testing.assert_array_equal(
        got, robj.cheap_objectives_batch(
            renc, profile=rcb.get_backend(profile).profile))
    genomes = tenc.to_genomes()[:20]
    np.testing.assert_array_equal(
        tobj.cheap_objectives_batch(genomes, profile=PROFILES[profile]),
        got[:20])
    for i, g in enumerate(genomes):
        np.testing.assert_array_equal(
            tobj.cheap_objectives(g, profile=PROFILES[profile]), got[i])
    assert tobj.cheap_objectives_batch([]).shape == (0, 7)


def test_get_backend_resolution():
    be = tcb.get_backend(FPGA_ZU)
    assert isinstance(be, tcb.FPGAAnalyticBackend)
    assert tcb.get_backend(FPGA_ZU) is be
    assert tcb.get_backend("fpga_zu").profile is FPGA_ZU
    assert tcb.get_backend("tpu_roofline") is tcb.TPU_ROOFLINE
    assert tcb.get_backend(be) is be
    multi = tcb.get_backend([FPGA_ZCU102, tcb.get_backend(["fpga_zu"])])
    assert len(multi) == 2 and multi.schema.platforms == \
        ("fpga_zcu102", "fpga_zu")
    with pytest.raises(KeyError):
        tcb.get_backend("no_such_backend")
    with pytest.raises(ValueError):
        tcb.MultiPlatformBackend(["fpga_zu", "fpga_zu"])


def test_tpu_roofline_terms_match_reference():
    got = tcb.TPU_ROOFLINE.roofline_terms(3e12, 4e9, 1e8, chips=4)
    want = rcb.TPU_ROOFLINE.roofline_terms(3e12, 4e9, 1e8, chips=4)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_expensive_objectives_and_candidate():
    r = TrainResult(detection_rate=0.93, false_alarm_rate=0.1, val_loss=0.2,
                    steps=5)
    np.testing.assert_array_equal(
        tobj.expensive_objectives(r),
        robj.expensive_objectives(rtrainer.TrainResult(0.93, 0.1, 0.2, 5)))
    g = tgen.random_genome(np.random.default_rng(1), DEFAULT_SPACE)
    c = tobj.Candidate(genome=g, cheap=np.arange(7.0))
    assert not c.trained and not c.meets_constraints()
    np.testing.assert_array_equal(c.objective_vector()[7:], [1.0, 1.0])
    c.expensive = tobj.expensive_objectives(r)
    assert c.trained and c.meets_constraints(0.9, 0.2)
    assert not c.meets_constraints(0.95, 0.2)


def _arrays(tenc, seed=0):
    rng = np.random.default_rng(seed)
    be = tcb.get_backend(["fpga_zu", "tpu_roofline"])
    exp = rng.uniform(0, 0.4, size=(len(tenc), 2))
    exp[::3] = np.nan                   # every third member untrained
    return tobj.PopulationArrays(
        enc=tenc, cheap=be.evaluate_batch(tenc), expensive=exp,
        phash=np.asarray(tenc.batch_phenotype_hash(DEFAULT_SPACE),
                         dtype=object),
        born=rng.integers(0, 5, len(tenc)), schema=be.schema)


def _assert_same(a, b):
    np.testing.assert_array_equal(a.enc.op, b.enc.op)
    np.testing.assert_array_equal(a.enc.conn, b.enc.conn)
    np.testing.assert_array_equal(a.cheap, b.cheap)
    np.testing.assert_array_equal(a.expensive, b.expensive)
    assert list(a.phash) == list(b.phash)
    np.testing.assert_array_equal(a.born, b.born)


def test_population_arrays_round_trip(pops):
    """take / concat / to_candidates / from_candidates lose nothing, and
    the objective view substitutes the schema's pessimistic row."""
    _, tenc = pops
    pop = _arrays(tenc)
    idx = np.arange(len(pop))
    parts = [pop.take(idx[:40]), pop.take(idx[40:41]), pop.take(idx[41:])]
    _assert_same(tobj.PopulationArrays.concat(parts), pop)
    empty = pop.take(np.asarray([], dtype=np.int64))
    assert tobj.PopulationArrays.concat([empty, pop]) is pop
    back = tobj.PopulationArrays.from_candidates(pop.to_candidates(),
                                                 schema=pop.schema)
    _assert_same(back, pop)
    obj = pop.objective_matrix()
    assert obj.shape == (len(pop), len(pop.full_schema))
    np.testing.assert_array_equal(obj[::3, -2:], 1.0)
    mask = pop.feasible_mask(0.9, 0.2)
    assert not mask[::3].any()
    assert list(mask) == [c.meets_constraints(0.9, 0.2)
                          for c in pop.to_candidates()]
    legacy = tobj.PopulationArrays(enc=tenc, cheap=pop.cheap[:, :7],
                                   expensive=pop.expensive, phash=pop.phash,
                                   born=pop.born)
    assert legacy.cheap_schema is tobj.LEGACY_CHEAP_SCHEMA
    with pytest.raises(ValueError, match="schema-less"):
        dataclasses.replace(legacy, cheap=pop.cheap).cheap_schema
