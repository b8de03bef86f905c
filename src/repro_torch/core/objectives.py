"""Objective registry — the paper's §VI objective set.

A copy of ``repro/core/objectives.py`` (numpy only), imports repointed to
the port; ``TrainResult`` is the port trainer's.

"The optimization objectives are power, energy and latency each with and
without unrolling, and additionally number of parameters, detection and
false alarm rate.  All objectives are considered at the same time in the
Pareto frontier."

Cheap objectives (no training needed) come from the analytic hardware models
of :mod:`repro_torch.core.hw_model`; expensive objectives (detection / false-alarm
rate) require candidate training.  All values are oriented for MINIMIZATION.

Column layout is described by an
:class:`~repro_torch.core.objective_schema.ObjectiveSchema` (DESIGN.md §10): a
single-platform backend yields the classic 7-column ``CHEAP_NAMES`` matrix,
a :class:`~repro_torch.core.cost_backend.MultiPlatformBackend` a ``K*7``-column
one with per-platform groups.  The canonical names live in
:mod:`repro_torch.core.objective_schema` and are re-exported here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.cost_backend import (BackendSpec, backend_schema,
                                           get_backend)
from repro_torch.core.genome import Genome, PopulationEncoding
from repro_torch.core.hw_model import FPGA_ZU, HardwareProfile, estimate
from repro_torch.core.objective_schema import (  # noqa: F401  (re-exports)
    ALL_NAMES,
    CHEAP_NAMES,
    Constraints,
    EXPENSIVE_NAMES,
    LEGACY_CHEAP_SCHEMA,
    ObjectiveSchema,
    pessimistic_expensive,
)
from repro_torch.core.search_space import DEFAULT_SPACE, SearchSpace
from repro_torch.core.trainer import TrainResult


def cheap_objectives(g: Genome, *, profile: HardwareProfile = FPGA_ZU,
                     space: SearchSpace = DEFAULT_SPACE) -> np.ndarray:
    """The 7 analytic objectives: {power, energy, latency} x {min,max alpha}
    + parameter count."""
    est_min = estimate(g, strategy="min", profile=profile, space=space)
    est_max = estimate(g, strategy="max", profile=profile, space=space)
    return np.asarray([
        est_min.p_total_w,
        est_max.p_total_w,
        est_min.e_total_j,
        est_max.e_total_j,
        est_min.latency_s,
        est_max.latency_s,
        float(est_min.params),
    ], dtype=np.float64)


def cheap_objectives_batch(
    genomes, *,
    backend: Optional[BackendSpec] = None,
    profile: HardwareProfile = FPGA_ZU,
    space: SearchSpace = DEFAULT_SPACE,
) -> np.ndarray:
    """Batched :func:`cheap_objectives`: ``(N, C)`` in backend-schema order
    (``C = 7`` for a single platform, ``K*7`` for a multi-platform backend).

    ``genomes`` is a sequence of :class:`Genome` or a ready
    :class:`PopulationEncoding`.  Evaluation routes through a pluggable
    :class:`~repro_torch.core.cost_backend.CostBackend`; by default the vectorized
    Eq. 1-4 analytic backend for ``profile`` (bit-for-bit consistent with the
    scalar path — this is the search's hot loop, DESIGN.md §2).
    """
    be = get_backend(profile if backend is None else backend)
    if not isinstance(genomes, PopulationEncoding):
        if len(genomes) == 0:
            return np.zeros((0, len(backend_schema(be))), dtype=np.float64)
        genomes = PopulationEncoding.from_genomes(list(genomes))
    return be.evaluate_batch(genomes, space=space)


def expensive_objectives(result: TrainResult) -> np.ndarray:
    """(miss rate, false-alarm rate) — both minimized; miss = 1 - detection."""
    return np.asarray([1.0 - result.detection_rate,
                       result.false_alarm_rate], dtype=np.float64)


PESSIMISTIC_EXPENSIVE = np.asarray([1.0, 1.0])  # untrained placeholder


@dataclasses.dataclass
class Candidate:
    """A genome plus every objective value the search knows about."""

    genome: Genome
    cheap: np.ndarray
    expensive: Optional[np.ndarray] = None        # None until trained
    train_result: Optional[TrainResult] = None
    phash: str = ""
    generation: int = 0

    def objective_vector(self) -> np.ndarray:
        exp = self.expensive if self.expensive is not None \
            else PESSIMISTIC_EXPENSIVE
        return np.concatenate([self.cheap, exp])

    @property
    def trained(self) -> bool:
        return self.expensive is not None

    def meets_constraints(self,
                          det_min: Union[None, float, Constraints] = None,
                          fa_max: Optional[float] = None) -> bool:
        """Hard acceptance limits; pass a :class:`Constraints` or the
        legacy ``(det_min, fa_max)`` floats (default: paper limits)."""
        if self.expensive is None:
            return False
        return bool(Constraints.coerce(det_min, fa_max)
                    .ok_rows(self.expensive[None, :])[0])


def objective_matrix(pop: Sequence[Candidate]) -> np.ndarray:
    return np.stack([c.objective_vector() for c in pop])


def cheap_matrix(pop: Sequence[Candidate]) -> np.ndarray:
    return np.stack([c.cheap for c in pop])


# ---------------------------------------------------------------------------
# Struct-of-arrays population (DESIGN.md §8)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PopulationArrays:
    """A whole population as stacked arrays — the search's resident state.

    Bundles the gene arrays (:class:`~repro_torch.core.genome.PopulationEncoding`)
    with the cheap/expensive objective matrices, phenotype hashes and birth
    generations, so every generation-step operation (parent sampling,
    preselection, non-dominated sort, environmental selection) runs over
    arrays; :class:`Candidate` objects are materialized only at the edges
    (training dispatch, checkpoints, reports).  ``expensive`` rows are NaN
    until the member is trained; :meth:`objective_matrix` substitutes the
    pessimistic placeholder exactly like ``Candidate.objective_vector``.

    ``schema`` names the cheap columns (platform-tagged for multi-platform
    backends); ``None`` means the legacy single-platform 7-column layout.
    """

    enc: "PopulationEncoding"
    cheap: np.ndarray       # (N, C) float64 — cheap-schema column order
    expensive: np.ndarray   # (N, 2) float64 — NaN rows = untrained
    phash: np.ndarray       # (N,) object — phenotype-hash dedup keys
    born: np.ndarray        # (N,) int64 — generation each member was created
    schema: Optional[ObjectiveSchema] = None   # cheap columns; None = legacy

    def __len__(self) -> int:
        return len(self.enc)

    @property
    def cheap_schema(self) -> ObjectiveSchema:
        """The cheap-column schema (legacy 7-column layout when unset)."""
        if self.schema is not None:
            return self.schema
        if self.cheap.shape[1] == len(LEGACY_CHEAP_SCHEMA):
            return LEGACY_CHEAP_SCHEMA
        raise ValueError(
            f"schema-less cheap matrix with {self.cheap.shape[1]} columns "
            f"(legacy layout has {len(LEGACY_CHEAP_SCHEMA)})")

    @property
    def full_schema(self) -> ObjectiveSchema:
        """Cheap + expensive columns — :meth:`objective_matrix`'s layout."""
        return self.cheap_schema.with_expensive()

    @property
    def trained_mask(self) -> np.ndarray:
        return np.isfinite(self.expensive).all(axis=1)

    def objective_matrix(self) -> np.ndarray:
        """(N, C+E) full objective matrix (``full_schema`` column order),
        pessimistic where untrained.  The placeholder row is derived from
        the schema's expensive columns (width and worst-case values), so a
        schema with a non-default expensive set stays consistent."""
        worst = pessimistic_expensive(self.full_schema)
        exp = np.where(np.isfinite(self.expensive), self.expensive,
                       worst[None, :])
        return np.concatenate([self.cheap, exp], axis=1)

    def feasible_mask(self,
                      det_min: Union[None, float, Constraints] = None,
                      fa_max: Optional[float] = None) -> np.ndarray:
        """Vectorized ``Candidate.meets_constraints`` (untrained = False).
        Pass a :class:`Constraints` or the legacy float pair."""
        cons = Constraints.coerce(det_min, fa_max)
        return self.trained_mask & cons.ok_rows(self.expensive)

    def take(self, idx) -> "PopulationArrays":
        idx = np.asarray(idx)
        return PopulationArrays(
            enc=self.enc.take(idx), cheap=self.cheap[idx],
            expensive=self.expensive[idx], phash=self.phash[idx],
            born=self.born[idx], schema=self.schema)

    @classmethod
    def concat(cls, parts: Sequence["PopulationArrays"]
               ) -> "PopulationArrays":
        parts = [p for p in parts if len(p)]
        if len(parts) == 1:
            return parts[0]
        return cls(
            enc=PopulationEncoding.concatenate([p.enc for p in parts]),
            cheap=np.concatenate([p.cheap for p in parts]),
            expensive=np.concatenate([p.expensive for p in parts]),
            phash=np.concatenate([p.phash for p in parts]),
            born=np.concatenate([p.born for p in parts]),
            schema=parts[0].schema)

    # ------------------------------------------------------- object edges
    def candidate(self, i: int) -> Candidate:
        """Materialize one member as a :class:`Candidate`."""
        trained = bool(np.isfinite(self.expensive[i]).all())
        return Candidate(
            genome=self.enc.genome(i), cheap=self.cheap[i].copy(),
            expensive=self.expensive[i].copy() if trained else None,
            phash=str(self.phash[i]), generation=int(self.born[i]))

    def to_candidates(self) -> List[Candidate]:
        return [self.candidate(i) for i in range(len(self))]

    @classmethod
    def from_candidates(cls, cands: Sequence[Candidate],
                        schema: Optional[ObjectiveSchema] = None
                        ) -> "PopulationArrays":
        exp = np.full((len(cands), len(EXPENSIVE_NAMES)), np.nan)
        for i, c in enumerate(cands):
            if c.expensive is not None:
                exp[i] = c.expensive
        return cls(
            enc=PopulationEncoding.from_genomes([c.genome for c in cands]),
            cheap=np.stack([np.asarray(c.cheap, np.float64) for c in cands]),
            expensive=exp,
            phash=np.asarray([c.phash for c in cands], dtype=object),
            born=np.asarray([c.generation for c in cands], dtype=np.int64),
            schema=schema)
