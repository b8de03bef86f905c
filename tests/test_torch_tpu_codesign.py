"""The port's ``tpu_codesign`` (a numpy copy) against ``repro``'s, bit for
bit: every estimate, the frontier and the pick of every arch's train_4k
cell, on both production meshes."""
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.core import tpu_codesign as jcd
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.core import tpu_codesign as tcd

MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]


def _same(a, b):
    assert (a.compute_s, a.memory_s, a.collective_s, a.act_gib) == \
        (b.compute_s, b.memory_s, b.collective_s, b.act_gib)


@pytest.mark.parametrize("arch", ALL_ARCHS)
@pytest.mark.parametrize("mesh", [0, 1])
def test_frontier_and_pick_equal_bit_for_bit(arch, mesh):
    tg, tc, tf = tcd.enumerate_frontier(get_config(arch), SHAPES["train_4k"],
                                        MESHES[mesh])
    jg, jc, jf = jcd.enumerate_frontier(jax_get_config(arch),
                                        JAX_SHAPES["train_4k"], MESHES[mesh])
    assert [g.short() for g in tg] == [g.short() for g in jg]
    for a, b in zip(tc, jc):
        _same(a, b)
    np.testing.assert_array_equal(tf, jf)
    for cap in (4.0, 16.0, 64.0):
        (g1, c1), (g2, c2) = (tcd.best_by_bound(tg, tc, tf, cap),
                              jcd.best_by_bound(jg, jc, jf, cap))
        assert g1.short() == g2.short()
        _same(c1, c2)


def test_search_space_equal():
    assert tcd.SEARCH_SPACE == jcd.SEARCH_SPACE
    assert tcd.ImplGenome().short() == jcd.ImplGenome().short()


def test_codesign_selects_adopted_kimi_config():
    """As ``tests/test_tpu_codesign.py``: the pick under the 16 GiB
    activation constraint is the adopted (mb=4, ep_a2a) point."""
    cfg = get_config("kimi-k2-1t-a32b")
    g, _ = tcd.best_by_bound(*tcd.enumerate_frontier(
        cfg, SHAPES["train_4k"], MESHES[0]), max_act_gib=16.0)
    assert g.moe_impl == "ep_a2a" and g.microbatches == cfg.microbatches
