"""The port's copy of ``core/selection.py`` against ``repro``'s, bit for
bit: the KDE densities and weights, and the parent and child draws from
one ``np.random.default_rng`` seed on each side."""
import numpy as np
import pytest

from repro.core import selection as ref
from repro_torch.core import selection as port


def _pop(seed, n=24, d=4):
    rng = np.random.default_rng(seed)
    pop = rng.normal(size=(n, d))
    pop[: n // 4] = pop[0]              # a cluster of identical points
    return pop


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kde_density(seed):
    pop = _pop(seed)
    q = np.random.default_rng(seed + 10).normal(size=(31, 4))
    got, want = port.GaussianKDE(pop), ref.GaussianKDE(pop)
    np.testing.assert_array_equal(got.h, want.h)
    np.testing.assert_array_equal(got.density(q), want.density(q))
    np.testing.assert_array_equal(got.density(q, chunk=4),
                                  want.density(q, chunk=4))


@pytest.mark.parametrize("cols", [None, np.array([0, 2])])
@pytest.mark.parametrize("seed", [0, 1])
def test_inverse_density_weights(seed, cols):
    pop = _pop(seed)
    q = np.random.default_rng(seed + 5).normal(size=(9, 4))
    np.testing.assert_array_equal(
        port.inverse_density_weights(pop, cols=cols),
        ref.inverse_density_weights(pop, cols=cols))
    np.testing.assert_array_equal(
        port.inverse_density_weights(pop, q, cols=cols),
        ref.inverse_density_weights(pop, q, cols=cols))
    same = np.ones((5, 3))              # degenerate: uniform weights
    np.testing.assert_array_equal(port.inverse_density_weights(same),
                                  ref.inverse_density_weights(same))


@pytest.mark.parametrize("cols", [None, np.array([1, 3])])
@pytest.mark.parametrize("seed", [0, 7])
def test_parent_and_child_draws(seed, cols):
    pop = _pop(seed)
    children = np.random.default_rng(seed + 1).normal(size=(20, 4))
    rng_p, rng_r = (np.random.default_rng(seed) for _ in range(2))
    np.testing.assert_array_equal(
        port.sample_parents(rng_p, pop, 11, cols=cols),
        ref.sample_parents(rng_r, pop, 11, cols=cols))
    np.testing.assert_array_equal(
        port.preselect_children(rng_p, pop, children, 6, cols=cols),
        ref.preselect_children(rng_r, pop, children, 6, cols=cols))
    np.testing.assert_array_equal(
        port.preselect_children(rng_p, pop, children[:4], 6, cols=cols),
        ref.preselect_children(rng_r, pop, children[:4], 6, cols=cols))
    # the streams stayed in step
    assert rng_p.bit_generator.state == rng_r.bit_generator.state
