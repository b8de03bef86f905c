"""Multi-objective machinery: non-dominated sorting, crowding, hypervolume.

A copy of ``repro/core/pareto.py`` (numpy only).

All objectives are MINIMIZED.  Callers negate "higher is better" metrics
(e.g. detection rate) before handing them in.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def dominates(a: np.ndarray, b: np.ndarray, eps: float = 0.0) -> bool:
    """a epsilon-dominates b: a <= b + eps everywhere, strictly < somewhere."""
    return bool(np.all(a <= b + eps) and np.any(a < b - eps))


def non_dominated_sort_reference(points: np.ndarray) -> List[np.ndarray]:
    """Pure-Python fast non-dominated sort (Deb et al.).

    O(N²) with a Python inner loop — kept as the executable reference that
    the vectorized :func:`non_dominated_sort` is property-tested against
    (tests/test_pareto.py) and that benchmarks/nas_loop_bench.py times the
    array-resident loop against.
    """
    n = len(points)
    if n == 0:
        return []
    dominated_by: List[List[int]] = [[] for _ in range(n)]
    dom_count = np.zeros(n, dtype=np.int64)
    for i in range(n):
        for j in range(i + 1, n):
            if dominates(points[i], points[j]):
                dominated_by[i].append(j)
                dom_count[j] += 1
            elif dominates(points[j], points[i]):
                dominated_by[j].append(i)
                dom_count[i] += 1
    fronts: List[np.ndarray] = []
    current = np.nonzero(dom_count == 0)[0]
    while len(current):
        fronts.append(current)
        nxt: List[int] = []
        for i in current:
            for j in dominated_by[i]:
                dom_count[j] -= 1
                if dom_count[j] == 0:
                    nxt.append(j)
        current = np.asarray(sorted(nxt), dtype=np.int64)
    return fronts


def domination_matrix(points: np.ndarray, row_chunk: int = 256) -> np.ndarray:
    """``(N, N)`` bool, ``[i, j]`` = point i dominates point j.

    Built in row chunks, accumulating the all-``<=`` / any-``<`` conditions
    one objective column at a time: the intermediates stay 2-D and
    contiguous (cache-friendly, memory-bounded) instead of a ``(chunk, N,
    M)`` broadcast with a strided last-axis reduction.
    """
    points = np.asarray(points, dtype=np.float64)
    n, m = points.shape
    cols = [np.ascontiguousarray(points[:, k]) for k in range(m)]
    dom = np.empty((n, n), dtype=bool)
    for s in range(0, n, row_chunk):
        e = min(n, s + row_chunk)
        le = np.ones((e - s, n), dtype=bool)   # all(a <= b)
        lt = np.zeros((e - s, n), dtype=bool)  # any(a < b)
        for c in cols:
            blk = c[s:e, None]
            le &= blk <= c[None, :]
            lt |= blk < c[None, :]
        dom[s:e] = le & lt
    return dom


def domination_matrices(points: np.ndarray,
                        col_groups: Sequence[Sequence[int]],
                        row_chunk: int = 256) -> List[np.ndarray]:
    """Domination matrices for several objective-column subsets in one pass.

    ``out[g][i, j]`` = point i dominates point j *restricted to columns
    ``col_groups[g]``* — the objective-subset views behind per-platform and
    goal-conditioned Pareto fronts.  The per-column ``<=`` / ``<``
    comparison blocks are computed once per row chunk and folded into every
    group containing the column, so K subset matrices cost one matrix's
    worth of comparisons plus K cheap boolean folds (instead of K full
    :func:`domination_matrix` passes).
    """
    points = np.asarray(points, dtype=np.float64)
    n, _ = points.shape
    groups = [np.asarray(g, dtype=np.int64) for g in col_groups]
    if any(len(g) == 0 for g in groups):
        raise ValueError("empty objective-column group")
    needed = sorted({int(c) for g in groups for c in g})
    cols = {k: np.ascontiguousarray(points[:, k]) for k in needed}
    doms = [np.empty((n, n), dtype=bool) for _ in groups]
    for s in range(0, n, row_chunk):
        e = min(n, s + row_chunk)
        le_blk: dict = {}
        lt_blk: dict = {}
        for k in needed:
            c = cols[k]
            blk = c[s:e, None]
            le_blk[k] = blk <= c[None, :]
            lt_blk[k] = blk < c[None, :]
        for g, dom in zip(groups, doms):
            le = np.ones((e - s, n), dtype=bool)
            lt = np.zeros((e - s, n), dtype=bool)
            for k in g:
                le &= le_blk[int(k)]
                lt |= lt_blk[int(k)]
            dom[s:e] = le & lt
    return doms


class PartialDomination:
    """A domination matrix split into an early and a late column fold.

    The search pipeline's host-overlap window (DESIGN.md §11) builds the
    cheap-column ``all(<=)`` / ``any(<)`` accumulators for the merged
    population *while the generation's buckets train on the devices*; when
    the expensive objectives land, :meth:`finish` folds just those columns
    in.  Boolean ``&=`` / ``|=`` folds are order-independent, so the result
    is bit-identical to ``domination_matrix(np.concatenate([early, late],
    axis=1))`` — the overlapped pipeline's selection is exactly the
    synchronous loop's.
    """

    def __init__(self, early: np.ndarray, row_chunk: int = 256):
        early = np.asarray(early, dtype=np.float64)
        self._n = early.shape[0]
        self._row_chunk = row_chunk
        n = self._n
        self._le = np.empty((n, n), dtype=bool)
        self._lt = np.empty((n, n), dtype=bool)
        cols = [np.ascontiguousarray(early[:, k])
                for k in range(early.shape[1])]
        for s in range(0, n, row_chunk):
            e = min(n, s + row_chunk)
            le = np.ones((e - s, n), dtype=bool)
            lt = np.zeros((e - s, n), dtype=bool)
            for c in cols:
                blk = c[s:e, None]
                le &= blk <= c[None, :]
                lt |= blk < c[None, :]
            self._le[s:e] = le
            self._lt[s:e] = lt

    def finish(self, late: np.ndarray) -> np.ndarray:
        """Fold the late columns and return the full domination matrix.
        Consumes the accumulators in place (call once)."""
        late = np.asarray(late, dtype=np.float64)
        if late.shape[0] != self._n:
            raise ValueError(f"late columns have {late.shape[0]} rows; "
                             f"early fold had {self._n}")
        n, row_chunk = self._n, self._row_chunk
        cols = [np.ascontiguousarray(late[:, k])
                for k in range(late.shape[1])]
        for s in range(0, n, row_chunk):
            e = min(n, s + row_chunk)
            for c in cols:
                blk = c[s:e, None]
                self._le[s:e] &= blk <= c[None, :]
                self._lt[s:e] |= blk < c[None, :]
        return self._le & self._lt


def _peel_fronts(dom: np.ndarray):
    """Yield fronts from a domination matrix (Deb peeling, vectorized).

    Each round takes the zero-domination-count survivors as the next front
    and subtracts their column counts.  Yields exactly the reference fronts,
    ascending index order within each; lazy so callers that stop early
    (environmental selection at capacity) skip the remaining rounds.
    """
    n = len(dom)
    dom_count = dom.sum(axis=0)
    assigned = np.zeros(n, dtype=bool)
    n_done = 0
    while n_done < n:
        current = np.nonzero((dom_count == 0) & ~assigned)[0]
        yield current
        assigned[current] = True
        n_done += len(current)
        dom_count -= dom[current].sum(axis=0)


def non_dominated_sort(points: np.ndarray,
                       dom: Optional[np.ndarray] = None) -> List[np.ndarray]:
    """Fast non-dominated sort (Deb et al.). Returns fronts of indices,
    front 0 = Pareto-optimal.

    Vectorized: one domination matrix plus front peeling.  Produces exactly
    the same fronts (including the ascending index order within each front)
    as :func:`non_dominated_sort_reference`.  Pass a precomputed ``dom``
    (:func:`domination_matrix`) to share it across calls.
    """
    if len(points) == 0:
        return []
    return list(_peel_fronts(domination_matrix(points) if dom is None
                             else dom))


def pareto_front(points: np.ndarray,
                 dom: Optional[np.ndarray] = None) -> np.ndarray:
    """Indices of the non-dominated points (front 0 only — no peeling)."""
    if len(points) == 0:
        return np.asarray([], dtype=np.int64)
    if dom is None:
        dom = domination_matrix(points)
    return np.nonzero(dom.sum(axis=0) == 0)[0]


def crowding_distance(points: np.ndarray) -> np.ndarray:
    """NSGA-II crowding distance within one front (inf at the boundary)."""
    n, m = points.shape
    if n <= 2:
        return np.full(n, np.inf)
    dist = np.zeros(n)
    for k in range(m):
        order = np.argsort(points[:, k], kind="stable")
        span = points[order[-1], k] - points[order[0], k]
        dist[order[0]] = dist[order[-1]] = np.inf
        if span <= 0:
            continue
        gaps = (points[order[2:], k] - points[order[:-2], k]) / span
        dist[order[1:-1]] += gaps
    return dist


def environmental_selection(points: np.ndarray, capacity: int,
                            dom: Optional[np.ndarray] = None) -> np.ndarray:
    """Keep `capacity` indices: fill whole fronts, break ties by crowding.

    Fronts are peeled lazily, so rounds past capacity are never computed.
    Pass a precomputed ``dom`` matrix to share it across calls.
    """
    if len(points) == 0:
        return np.asarray([], dtype=np.int64)
    if dom is None:
        dom = domination_matrix(points)
    keep: List[int] = []
    for front in _peel_fronts(dom):
        if len(keep) + len(front) <= capacity:
            keep.extend(front.tolist())
        else:
            need = capacity - len(keep)
            cd = crowding_distance(points[front])
            order = np.argsort(-cd, kind="stable")
            keep.extend(front[order[:need]].tolist())
            break
    return np.asarray(sorted(keep), dtype=np.int64)


def hypervolume_2d(points: np.ndarray, ref: np.ndarray) -> float:
    """Exact 2-D hypervolume (minimization) w.r.t. reference point."""
    front = points[pareto_front(points)]
    front = front[np.argsort(front[:, 0])]
    hv, prev_y = 0.0, ref[1]
    for x, y in front:
        if x >= ref[0] or y >= prev_y:
            continue
        hv += (ref[0] - x) * (prev_y - y)
        prev_y = y
    return float(hv)


def normalize(points: np.ndarray) -> np.ndarray:
    """Per-objective min-max normalization (degenerate dims -> 0)."""
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    span = np.where(hi - lo > 1e-12, hi - lo, 1.0)
    return (points - lo) / span
