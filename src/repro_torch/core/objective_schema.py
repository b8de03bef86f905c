"""Named objective schema — the self-describing objective layer (DESIGN.md §10).

A copy of ``repro/core/objective_schema.py`` (numpy only).

Before this module the objective matrix was an implicit convention: "7
floats in ``CHEAP_NAMES`` order" for whichever single ``CostBackend`` the
search happened to be configured with.  That convention cannot express the
paper's *holistic* story — the same population steered toward different
deployment targets and design goals (low-energy, low-power, high-throughput
variants of one search, §VI-B) or scored against several platforms at once
for cross-platform Pareto fronts.

Three pieces live here, deliberately dependency-free (``numpy`` only) so
that ``trainer``, ``cost_backend`` and ``objectives`` can all import them
without cycles:

* :class:`ObjectiveSchema` — a tuple of :class:`ObjectiveColumn` (name,
  cheap/expensive kind, platform tag); the objective matrix's column axis
  as data.  Backends carry one; ``PopulationArrays`` carries one;
  checkpoints persist and validate one.
* :class:`Constraints` — the paper's hard acceptance limits (90 %
  detection / 20 % false alarm) as one dataclass consumed by
  ``TrainResult.meets_constraints``, ``Candidate.meets_constraints``,
  ``PopulationArrays.feasible_mask`` and :class:`DesignGoal` (previously
  three duplicated pairs of default floats).
* :class:`DesignGoal` — a deployment-goal spec: which schema columns drive
  non-dominated sorting/selection and the final report, plus the
  constraint filter.  The paper's three presets ship (`low_energy`,
  `low_power`, `high_throughput`) next to the all-columns `balanced`
  default that reproduces the ungoaled engine bit-for-bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

# Canonical objective names (paper §VI).  These are the single source of
# truth — ``repro_torch.core.objectives`` re-exports them.
CHEAP_NAMES: Tuple[str, ...] = (
    "power_min_alpha_w", "power_max_alpha_w",
    "energy_min_alpha_j", "energy_max_alpha_j",
    "latency_min_alpha_s", "latency_max_alpha_s",
    "n_params",
)
EXPENSIVE_NAMES: Tuple[str, ...] = ("miss_rate", "false_alarm_rate")
ALL_NAMES: Tuple[str, ...] = CHEAP_NAMES + EXPENSIVE_NAMES

# Worst case per expensive column (all rates in [0, 1], minimized).  The
# pessimistic placeholder row for untrained/failed members is derived from
# the schema through :func:`pessimistic_expensive` — never hard-coded as a
# 2-vector — so a schema with a different expensive column set cannot
# silently corrupt the expensive matrix.
EXPENSIVE_WORST: Dict[str, float] = {
    "miss_rate": 1.0,
    "false_alarm_rate": 1.0,
}


def pessimistic_expensive(schema: "ObjectiveSchema") -> np.ndarray:
    """The worst-case expensive row for ``schema`` — one value per
    expensive column, in schema order.  Unknown columns default to 1.0
    (every expensive objective is a minimized rate)."""
    cols = [schema.columns[int(i)] for i in schema.expensive_indices()]
    return np.asarray([EXPENSIVE_WORST.get(c.name, 1.0) for c in cols],
                      dtype=np.float64)


# ---------------------------------------------------------------------------
# Constraints — the one copy of the paper's hard acceptance limits
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Constraints:
    """Hard acceptance limits on the expensive objectives (paper §VI)."""

    det_min: float = 0.90
    fa_max: float = 0.20

    @classmethod
    def coerce(cls, det_min: Union[None, float, "Constraints"] = None,
               fa_max: Optional[float] = None) -> "Constraints":
        """Accept a ready Constraints or the legacy (det_min, fa_max) pair
        (either may be None to keep the paper default)."""
        if isinstance(det_min, Constraints):
            return det_min
        base = cls()
        return cls(base.det_min if det_min is None else float(det_min),
                   base.fa_max if fa_max is None else float(fa_max))

    def ok(self, detection_rate: float, false_alarm_rate: float) -> bool:
        return detection_rate >= self.det_min \
            and false_alarm_rate <= self.fa_max

    def ok_rows(self, expensive: np.ndarray) -> np.ndarray:
        """Vectorized check over ``(N, 2)`` rows in objectives orientation
        (miss rate, false-alarm rate — both minimized)."""
        exp = np.atleast_2d(np.asarray(expensive, dtype=np.float64))
        return ((1.0 - exp[:, 0]) >= self.det_min) \
            & (exp[:, 1] <= self.fa_max)


DEFAULT_CONSTRAINTS = Constraints()


# ---------------------------------------------------------------------------
# ObjectiveSchema
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ObjectiveColumn:
    """One column of the objective matrix.

    All stored values are oriented for MINIMIZATION (callers negate
    higher-is-better metrics before they enter the matrix — detection rate
    is stored as miss rate, etc.), so orientation is a documentation field
    rather than a transform: it records what the minimized number means.
    """

    name: str             # e.g. "energy_max_alpha_j"
    kind: str             # "cheap" | "expensive"
    platform: str = ""    # backend/platform tag; "" = platform-agnostic

    def __post_init__(self):
        if self.kind not in ("cheap", "expensive"):
            raise ValueError(f"bad column kind {self.kind!r}")

    @property
    def qualified(self) -> str:
        """``platform:name`` (or bare name for platform-agnostic columns)."""
        return f"{self.platform}:{self.name}" if self.platform else self.name


@dataclasses.dataclass(frozen=True)
class ObjectiveSchema:
    """An ordered, named description of an objective matrix's columns.

    The schema is what lets every downstream consumer (non-dominated sort,
    environmental selection, solution reports, checkpoints) ask for columns
    by meaning — name, platform, cheap/expensive class — instead of
    hard-coding positions.
    """

    columns: Tuple[ObjectiveColumn, ...]

    def __post_init__(self):
        quals = [c.qualified for c in self.columns]
        if len(set(quals)) != len(quals):
            dupes = sorted({q for q in quals if quals.count(q) > 1})
            raise ValueError(f"duplicate objective columns: {dupes}")

    def __len__(self) -> int:
        return len(self.columns)

    def __iter__(self):
        return iter(self.columns)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(c.name for c in self.columns)

    @property
    def qualified_names(self) -> Tuple[str, ...]:
        return tuple(c.qualified for c in self.columns)

    @property
    def platforms(self) -> Tuple[str, ...]:
        """Distinct platform tags, in first-appearance order ('' excluded)."""
        seen: List[str] = []
        for c in self.columns:
            if c.platform and c.platform not in seen:
                seen.append(c.platform)
        return tuple(seen)

    # ----------------------------------------------------------- queries
    def index(self, name: str, platform: Optional[str] = None) -> int:
        """Position of one column.  ``name`` may be qualified
        (``platform:name``); an unqualified name must be unambiguous unless
        ``platform`` narrows it."""
        matches = self.indices(names=(name,), platform=platform)
        if len(matches) == 0:
            raise KeyError(f"no objective column {name!r}"
                           + (f" for platform {platform!r}" if platform
                              else "")
                           + f" (have: {list(self.qualified_names)})")
        if len(matches) > 1:
            raise KeyError(
                f"objective column {name!r} is ambiguous across platforms "
                f"{[self.columns[i].platform for i in matches]}; qualify it")
        return int(matches[0])

    def indices(self, names: Optional[Sequence[str]] = None,
                platform: Optional[Union[str, Sequence[str]]] = None,
                kind: Optional[str] = None) -> np.ndarray:
        """Positions of every column matching the filters, schema order.

        ``names`` entries may be bare (``energy_max_alpha_j``) or qualified
        (``fpga_zu:energy_max_alpha_j``); platform-agnostic columns match
        any platform filter (they mean the same thing everywhere).
        """
        if isinstance(platform, str):
            platform = (platform,)
        out = []
        for i, c in enumerate(self.columns):
            if kind is not None and c.kind != kind:
                continue
            if platform is not None and c.platform \
                    and c.platform not in platform:
                continue
            if names is not None \
                    and c.name not in names and c.qualified not in names:
                continue
            out.append(i)
        return np.asarray(out, dtype=np.int64)

    def cheap_indices(self) -> np.ndarray:
        return self.indices(kind="cheap")

    def expensive_indices(self) -> np.ndarray:
        return self.indices(kind="expensive")

    def platform_group(self, platform: str) -> np.ndarray:
        """Columns belonging to one platform plus the platform-agnostic
        (expensive) columns — a per-platform objective view."""
        if platform not in self.platforms:
            raise KeyError(f"no platform {platform!r} in schema "
                           f"(have: {list(self.platforms)})")
        return self.indices(platform=platform)

    def select(self, idx: Sequence[int]) -> "ObjectiveSchema":
        return ObjectiveSchema(tuple(self.columns[int(i)] for i in idx))

    # ------------------------------------------------------ constructors
    @staticmethod
    def cheap(platform: str = "") -> "ObjectiveSchema":
        """The 7 analytic objectives (``CHEAP_NAMES``) for one platform."""
        return ObjectiveSchema(tuple(
            ObjectiveColumn(n, "cheap", platform) for n in CHEAP_NAMES))

    @staticmethod
    def expensive() -> "ObjectiveSchema":
        return ObjectiveSchema(tuple(
            ObjectiveColumn(n, "expensive") for n in EXPENSIVE_NAMES))

    @staticmethod
    def concat(parts: Sequence["ObjectiveSchema"]) -> "ObjectiveSchema":
        return ObjectiveSchema(tuple(
            c for p in parts for c in p.columns))

    def with_expensive(self) -> "ObjectiveSchema":
        """This (cheap) schema + the expensive columns — the full objective
        matrix layout that selection operates on."""
        return ObjectiveSchema.concat([self, ObjectiveSchema.expensive()])

    # ------------------------------------------------------ serialization
    def to_json(self) -> List[Dict[str, str]]:
        return [{"name": c.name, "kind": c.kind, "platform": c.platform}
                for c in self.columns]

    @staticmethod
    def from_json(payload: Sequence[Dict[str, str]]) -> "ObjectiveSchema":
        return ObjectiveSchema(tuple(
            ObjectiveColumn(d["name"], d["kind"], d.get("platform", ""))
            for d in payload))


# The implicit pre-schema layout: 7 cheap columns of a single unnamed
# platform.  Used to adopt schema-less data (old checkpoints, raw arrays).
LEGACY_CHEAP_SCHEMA = ObjectiveSchema.cheap()


# ---------------------------------------------------------------------------
# DesignGoal
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DesignGoal:
    """A deployment goal: which objective columns steer the search.

    * ``objectives`` — cheap column names the goal cares about; ``()``
      means all of them.  Expensive columns (detection / false alarm)
      always participate in domination — dropping them would collapse the
      frontier's accuracy axis, which the paper never does.
    * ``platforms`` — restrict the goal to these platform tags; ``()``
      means every platform in the schema (cross-platform goal).
    * ``primary`` — the report-time ranking column
      (:meth:`~repro_torch.core.evolution.EvolutionarySearch.select_solution`).
      With several platforms in scope the selector minimizes the *worst*
      (max) primary value across them — a robust cross-platform pick.
    * ``constraints`` — hard limits for the feasibility filter; ``None``
      inherits the search config's limits.
    """

    name: str
    objectives: Tuple[str, ...] = ()
    platforms: Tuple[str, ...] = ()
    primary: str = "energy_max_alpha_j"
    constraints: Optional[Constraints] = None

    def selection_indices(self, schema: ObjectiveSchema) -> np.ndarray:
        """Columns of the *full* (cheap + expensive) schema that drive
        non-dominated sorting and environmental selection."""
        # every requested name must match something — a typo'd objective
        # silently dropped would steer a whole search the wrong way
        for name in self.objectives:
            if len(schema.indices(names=(name,), kind="cheap")) == 0:
                raise KeyError(
                    f"goal {self.name!r}: objective {name!r} not in schema "
                    f"{list(schema.qualified_names)}")
        for platform in self.platforms:
            if platform not in schema.platforms:
                raise KeyError(
                    f"goal {self.name!r}: platform {platform!r} not in "
                    f"schema (have: {list(schema.platforms)})")
        cheap = schema.indices(
            names=self.objectives or None,
            platform=self.platforms or None, kind="cheap")
        if len(cheap) == 0:
            raise KeyError(
                f"goal {self.name!r} selects no cheap objective columns "
                f"from schema {list(schema.qualified_names)}")
        return np.concatenate([cheap, schema.expensive_indices()])

    def primary_indices(self, schema: ObjectiveSchema) -> np.ndarray:
        """The primary column, once per platform in scope."""
        idx = schema.indices(names=(self.primary,),
                             platform=self.platforms or None, kind="cheap")
        if len(idx) == 0:
            raise KeyError(f"goal {self.name!r}: primary objective "
                           f"{self.primary!r} not in schema")
        return idx

    def effective_constraints(self, fallback: Constraints) -> Constraints:
        return self.constraints if self.constraints is not None else fallback


# The paper's §VI-B deployment presets + the all-objectives default.
BALANCED = DesignGoal(name="balanced")
LOW_ENERGY = DesignGoal(
    name="low_energy",
    objectives=("energy_min_alpha_j", "energy_max_alpha_j", "n_params"),
    primary="energy_max_alpha_j")
LOW_POWER = DesignGoal(
    name="low_power",
    objectives=("power_min_alpha_w", "power_max_alpha_w", "n_params"),
    primary="power_min_alpha_w")
HIGH_THROUGHPUT = DesignGoal(
    name="high_throughput",
    objectives=("latency_min_alpha_s", "latency_max_alpha_s", "n_params"),
    primary="latency_max_alpha_s")

GOALS: Dict[str, DesignGoal] = {
    g.name: g for g in (BALANCED, LOW_ENERGY, LOW_POWER, HIGH_THROUGHPUT)}


def get_goal(spec: Union[str, DesignGoal]) -> DesignGoal:
    """Resolve a goal name or pass a ready :class:`DesignGoal` through."""
    if isinstance(spec, DesignGoal):
        return spec
    if spec in GOALS:
        return GOALS[spec]
    raise KeyError(f"unknown design goal {spec!r} "
                   f"(presets: {sorted(GOALS)})")
