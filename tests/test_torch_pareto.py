"""The port's copy of ``core/pareto.py`` against ``repro``'s, bit for bit:
both are numpy, so every output must be equal, not close."""
import numpy as np
import pytest

from repro.core import pareto as ref
from repro_torch.core import pareto as port


def _clouds():
    """Seeded point clouds: continuous ones, ones on a coarse grid (ties in
    every column), exact duplicates, a degenerate column, a chain."""
    out = []
    for seed, (n, m) in enumerate([(40, 2), (60, 3), (90, 5), (257, 4)]):
        rng = np.random.default_rng(seed)
        out.append((f"normal{n}x{m}", rng.normal(size=(n, m))))
        out.append((f"grid{n}x{m}", rng.integers(0, 4, size=(n, m))
                    .astype(np.float64)))
    rng = np.random.default_rng(9)
    base = rng.normal(size=(12, 3))
    out.append(("duplicates", np.concatenate([base, base[:5], base[:2]])))
    degen = rng.normal(size=(30, 3))
    degen[:, 1] = 2.5
    out.append(("degenerate", degen))
    out.append(("chain", np.stack([np.arange(10.0)] * 3, axis=1)))
    return out


CLOUDS = _clouds()
IDS = [name for name, _ in CLOUDS]


def _fronts_equal(a, b):
    assert len(a) == len(b)
    for fa, fb in zip(a, b):
        np.testing.assert_array_equal(fa, fb)


@pytest.mark.parametrize("pts", [p for _, p in CLOUDS], ids=IDS)
def test_domination_and_sorts(pts):
    dom = port.domination_matrix(pts, row_chunk=7)
    np.testing.assert_array_equal(dom, ref.domination_matrix(pts))
    _fronts_equal(port.non_dominated_sort(pts),
                  ref.non_dominated_sort(pts))
    _fronts_equal(port.non_dominated_sort(pts, dom=dom),
                  ref.non_dominated_sort_reference(pts))
    np.testing.assert_array_equal(port.pareto_front(pts),
                                  ref.pareto_front(pts))
    groups = [[0], list(range(pts.shape[1])), [pts.shape[1] - 1, 0]]
    for got, want in zip(port.domination_matrices(pts, groups),
                         ref.domination_matrices(pts, groups)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pts", [p for _, p in CLOUDS], ids=IDS)
def test_partial_domination_finishes_to_the_full_matrix(pts):
    """The host-overlap fold: early columns first, the late ones at the
    join, equal to one domination matrix over all columns (and to the
    reference's own fold)."""
    split = max(1, pts.shape[1] - 1)
    got = port.PartialDomination(pts[:, :split], row_chunk=5) \
        .finish(pts[:, split:])
    np.testing.assert_array_equal(got, port.domination_matrix(pts))
    np.testing.assert_array_equal(
        got, ref.PartialDomination(pts[:, :split]).finish(pts[:, split:]))
    with pytest.raises(ValueError, match="rows"):
        port.PartialDomination(pts[:, :split]).finish(pts[1:, split:])


@pytest.mark.parametrize("pts", [p for _, p in CLOUDS], ids=IDS)
@pytest.mark.parametrize("cap", [1, 5, 16])
def test_crowding_and_environmental_selection(pts, cap):
    np.testing.assert_array_equal(port.crowding_distance(pts),
                                  ref.crowding_distance(pts))
    np.testing.assert_array_equal(port.environmental_selection(pts, cap),
                                  ref.environmental_selection(pts, cap))


@pytest.mark.parametrize("pts", [p for _, p in CLOUDS], ids=IDS)
def test_hypervolume_and_normalize(pts):
    two = pts[:, :2]
    refpt = two.max(axis=0) + 1.0
    assert port.hypervolume_2d(two, refpt) == ref.hypervolume_2d(two, refpt)
    np.testing.assert_array_equal(port.normalize(pts), ref.normalize(pts))


def test_empty_inputs():
    empty = np.zeros((0, 3))
    assert port.non_dominated_sort(empty) == []
    assert len(port.environmental_selection(empty, 4)) == 0
    assert len(port.pareto_front(empty)) == 0
    assert port.dominates(np.array([0.0, 1.0]), np.array([1.0, 1.0]))
    assert not port.dominates(np.array([1.0, 1.0]), np.array([1.0, 1.0]))
