"""The port's own copies of the reference's numpy modules on the ECG path
(layer costs, search space, genome, objective schema, hardware model, ECG
data) against ``repro``, bit for bit: numpy on both sides, the same
seeds, exact equality.  The port's scalar and batched estimate paths must
also equal each other (DESIGN.md §7), as ``repro``'s do.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import genome as jgenome
from repro.core import hw_model as jhw
from repro.core import objective_schema as jschema
from repro.core.search_space import DEFAULT_SPACE as JSPACE
from repro.data import ecg as jecg
from repro.hwlib import layers as jlayers
from repro_torch.core import genome as tgenome
from repro_torch.core import hw_model as thw
from repro_torch.core import objective_schema as tschema
from repro_torch.core.search_space import DEFAULT_SPACE as TSPACE
from repro_torch.data import ecg as tecg
from repro_torch.hwlib import layers as tlayers

N_SWEEP = 300
PROFILES = sorted(jhw.PROFILES)
ESTIMATE_FIELDS = ("t_total_s", "latency_s", "p_total_w", "e_total_j",
                   "e_wall_j", "throughput_sps", "params", "total_macs")


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _same(a, b):
    """Exact equality of two dataclass instances' fields (arrays too)."""
    fa, fb = _fields(a), _fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        va, vb = fa[k], fb[k]
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and np.array_equal(va, vb), k
        else:
            assert va == vb, k


def _genes(g):
    return tuple(getattr(g, f.name) for f in dataclasses.fields(g))


@pytest.fixture(scope="module")
def sweep():
    """The same seeded genomes drawn by each package's own sampler."""
    jr, tr = np.random.default_rng(0), np.random.default_rng(0)
    jg = [jgenome.random_genome(jr, JSPACE) for _ in range(N_SWEEP)]
    tg = [tgenome.random_genome(tr, TSPACE) for _ in range(N_SWEEP)]
    return jg, tg


def test_search_space_and_op_table_equal():
    assert [s.short() for s in JSPACE.ops] == [s.short() for s in TSPACE.ops]
    assert [_fields(s) for s in JSPACE.ops] == [_fields(s) for s in TSPACE.ops]
    assert [_fields(s) for s in JSPACE.head_specs()] == \
        [_fields(s) for s in TSPACE.head_specs()]
    for f in ("max_depth", "min_depth", "weight_bits", "act_bits",
              "input_bits", "input_decimations", "n_classes"):
        assert getattr(JSPACE, f) == getattr(TSPACE, f)
    assert [JSPACE.input_length(i) for i in range(2)] == \
        [TSPACE.input_length(i) for i in range(2)]


@pytest.mark.parametrize("in_len,in_ch", [(3750, 2), (1875, 32), (7, 16),
                                          (1, 8)])
def test_layer_cost_every_op(in_len, in_ch):
    for js, ts in zip(tuple(JSPACE.ops) + JSPACE.head_specs(),
                      tuple(TSPACE.ops) + TSPACE.head_specs()):
        try:
            want = jlayers.layer_cost(js, in_len, in_ch)
        except ValueError:
            with pytest.raises(ValueError):
                tlayers.layer_cost(ts, in_len, in_ch)
            continue
        got = tlayers.layer_cost(ts, in_len, in_ch)
        assert _fields(got) == _fields(want)
        assert got.alpha_max == want.alpha_max
        assert tlayers.out_shape(ts, in_len, in_ch) == \
            jlayers.out_shape(js, in_len, in_ch)


def test_op_cost_table_equal():
    _same(tlayers.OpCostTable.from_specs(tuple(TSPACE.ops)
                                         + TSPACE.head_specs()),
          jlayers.OpCostTable.from_specs(tuple(JSPACE.ops)
                                         + JSPACE.head_specs()))


def test_genome_decode_and_validity(sweep):
    jg, tg = sweep
    for a, b in zip(jg, tg):
        assert _genes(a) == _genes(b)
        assert a.active_nodes() == b.active_nodes()
        assert [s.short() for s in a.phenotype()] == \
            [s.short() for s in b.phenotype()]
        assert a.quant().short() == b.quant().short()
        assert a.input_length() == b.input_length()
        assert a.phenotype_hash() == b.phenotype_hash()
        assert a.is_valid() and b.is_valid()
        assert jgenome.decode_shapes(a) == tgenome.decode_shapes(b)
        assert jgenome.describe(a) == tgenome.describe(b)


def test_genome_validity_on_unchecked_genes():
    """Random gene tuples, most of them invalid: both packages agree on
    every one, and the port's batched check agrees with its scalar one."""
    rng = np.random.default_rng(1)
    d = TSPACE.max_depth
    tgs, jgs = [], []
    for _ in range(N_SWEEP):
        genes = (tuple(int(v) for v in rng.integers(0, 64, d)),
                 tuple(int(rng.integers(0, i + 1)) for i in range(d)),
                 int(rng.integers(0, d + 1)), int(rng.integers(0, 2)),
                 int(rng.integers(0, 2)), int(rng.integers(0, 2)),
                 int(rng.integers(0, 2)))
        tgs.append(tgenome.Genome(*genes))
        jgs.append(jgenome.Genome(*genes))
    valid = [g.is_valid() for g in tgs]
    assert valid == [g.is_valid() for g in jgs]
    assert 0 < sum(valid) < len(valid)
    enc = tgenome.PopulationEncoding.from_genomes(tgs)
    assert tgenome.is_valid_batch(enc).tolist() == valid


def test_batch_layer_costs_equal(sweep):
    jg, tg = sweep
    jenc = jgenome.PopulationEncoding.from_genomes(jg)
    tenc = tgenome.PopulationEncoding.from_genomes(tg)
    _same(thw.population_layer_costs(tenc), jhw.population_layer_costs(jenc))
    assert tenc.batch_phenotype_hash() == jenc.batch_phenotype_hash()


@pytest.mark.parametrize("strategy", ["min", "max"])
@pytest.mark.parametrize("profile", PROFILES)
def test_estimate_and_batch_estimate(sweep, profile, strategy):
    """Scalar and batched Eq. 1-4 of the port equal ``repro``'s and each
    other, exactly, for every profile and both strategies."""
    jg, tg = sweep
    jp, tp = jhw.PROFILES[profile], thw.PROFILES[profile]
    assert _fields(jp) == _fields(tp)
    scalar = [thw.estimate(g, strategy=strategy, profile=tp) for g in tg]
    for got, g in zip(scalar, jg):
        assert _fields(got) == _fields(jhw.estimate(g, strategy=strategy,
                                                    profile=jp))
    tenc = tgenome.PopulationEncoding.from_genomes(tg)
    batched = thw.estimate_population(tenc, strategy=strategy, profile=tp)
    _same(batched, jhw.estimate_population(
        jgenome.PopulationEncoding.from_genomes(jg), strategy=strategy,
        profile=jp))
    for i, want in enumerate(scalar):
        assert _fields(batched.row(i)) == _fields(want)
    shared = thw.SharedPopulationEval(thw.population_layer_costs(tenc))
    _same(thw.batch_estimate(shared.costs, strategy=strategy, profile=tp,
                             shared=shared), batched)


def test_layer_costs_and_alphas_for_the_compiler(sweep):
    jg, tg = sweep
    for a, b in zip(jg[:50], tg[:50]):
        jc, tc = jhw.layer_costs_for(a), thw.layer_costs_for(b)
        assert [_fields(c) for c in jc] == [_fields(c) for c in tc]
        for strategy in ("min", "max"):
            assert list(thw.resolve_alphas(tc, strategy, thw.FPGA_ZU)) == \
                list(jhw.resolve_alphas(jc, strategy, jhw.FPGA_ZU))


def test_genome_batch_operators_equal():
    """Same rng seed -> same populations from the batched samplers and
    genetic operators (they serve the search loop, still to port)."""
    jr, tr = np.random.default_rng(3), np.random.default_rng(3)
    ja = jgenome.random_population(jr, 64)
    ta = tgenome.random_population(tr, 64)
    _same(ta, ja)
    _same(tgenome.mutate_batch(ta, tr), jgenome.mutate_batch(ja, jr))
    jb, tb = jgenome.random_population(jr, 64), \
        tgenome.random_population(tr, 64)
    _same(tgenome.crossover_batch(ta, tb, tr),
          jgenome.crossover_batch(ja, jb, jr))
    g = ta.genome(0)
    assert _genes(tgenome.mutate(g, tr)) == \
        _genes(jgenome.mutate(ja.genome(0), jr))


def test_objective_schema_constraints_and_goals():
    assert sorted(tschema.GOALS) == sorted(jschema.GOALS)
    for name in jschema.GOALS:
        assert _fields(tschema.get_goal(name)) == \
            _fields(jschema.get_goal(name))
    jsch, tsch = jschema.ObjectiveSchema.cheap(), \
        tschema.ObjectiveSchema.cheap()
    assert tsch.qualified_names == jsch.qualified_names
    for det, fa in [(0.95, 0.1), (0.89, 0.1), (0.95, 0.25)]:
        assert tschema.Constraints().ok(det, fa) == \
            jschema.Constraints().ok(det, fa)


@pytest.mark.parametrize("decimation", [16, 32])
def test_ecg_dataset_and_split_equal(decimation):
    jx, jy = jecg.make_ecg_dataset(seed=3, n_samples=12,
                                   decimation=decimation)
    tx, ty = tecg.make_ecg_dataset(seed=3, n_samples=12,
                                   decimation=decimation)
    assert tx.shape == (12, 60000 // decimation, 2) and tx.dtype == jx.dtype
    assert np.array_equal(tx, jx) and np.array_equal(ty, jy)
    for (ja, jb), (ta, tb) in zip(jecg.train_val_split(jx, jy, seed=5),
                                  tecg.train_val_split(tx, ty, seed=5)):
        assert np.array_equal(ja, ta) and np.array_equal(jb, tb)
