"""Pluggable cost backends for batched cheap-objective evaluation.

A copy of ``repro/core/cost_backend.py`` (numpy only), imports repointed
to the port.  ``TPURooflineBackend`` scores a TPU v5e *as a search target*
from ``hw_model.TPU_V5E``'s constants: its numbers are cost-model data, not
measurements of the card the port runs on.

The search layers never touch Eq. 1-4 (or roofline) math directly: they hand
a :class:`~repro_torch.core.genome.PopulationEncoding` to a :class:`CostBackend`
and get back an objective matrix whose columns are described by the
backend's :class:`~repro_torch.core.objective_schema.ObjectiveSchema` (DESIGN.md
§2, §10).  Implementations:

* :class:`FPGAAnalyticBackend` — the paper's analytic Eq. 1-4 models,
  vectorized over the population, for any :class:`HardwareProfile` (the four
  calibrated profiles in :mod:`repro_torch.core.hw_model`).  ``(N, 7)`` in
  ``CHEAP_NAMES`` order, platform-tagged with the profile name.
* :class:`TPURooflineBackend` — the three-term v5e roofline.  Besides scoring
  genomes it owns the shared :meth:`~TPURooflineBackend.roofline_terms`
  helper (the reference's ``tpu_codesign`` and ``launch/roofline.py``
  consume it; the port has neither yet), so the pod-scale roofline math
  lives in exactly one place.
* :class:`MultiPlatformBackend` — a composite that scores one population
  against K member backends in a single call, sharing the decode/tabulation
  and the platform-independent Eq. 1-4 intermediates
  (:class:`~repro_torch.core.hw_model.SharedPopulationEval`); the result is an
  ``(N, K*7)`` matrix whose schema carries per-platform column groups —
  the engine behind cross-platform Pareto fronts.
"""
from __future__ import annotations

import inspect
from typing import Dict, List, Optional, Protocol, Sequence, Union, \
    runtime_checkable

import numpy as np

from repro_torch.core.genome import Genome, PopulationEncoding
from repro_torch.core.hw_model import (
    FPGA_ZU,
    PROFILES,
    TPU_V5E,
    HardwareProfile,
    RooflineTerms,
    SharedPopulationEval,
    batch_estimate,
    population_layer_costs,
    roofline,
)
from repro_torch.core.objective_schema import ObjectiveSchema
from repro_torch.core.search_space import DEFAULT_SPACE, SearchSpace


@runtime_checkable
class CostBackend(Protocol):
    """Scores populations analytically — the search's hot loop."""

    name: str

    def evaluate_batch(self, enc: PopulationEncoding, *,
                       space: SearchSpace = DEFAULT_SPACE) -> np.ndarray:
        """``(N, C)`` cheap-objective matrix (``schema`` column order)."""
        ...

    def evaluate(self, g: Genome, *,
                 space: SearchSpace = DEFAULT_SPACE) -> np.ndarray:
        """``(C,)`` objectives for a single genome."""
        ...


def backend_schema(be: CostBackend) -> ObjectiveSchema:
    """The backend's cheap-column schema.

    Backends written before the schema layer (or third-party ones) are
    adopted as one platform of 7 ``CHEAP_NAMES`` columns tagged with their
    ``platform`` attribute (falling back to ``name``).
    """
    schema = getattr(be, "schema", None)
    if schema is not None:
        return schema
    return ObjectiveSchema.cheap(getattr(be, "platform", be.name))


class FPGAAnalyticBackend:
    """Vectorized Eq. 1-4 evaluation against one hardware profile.

    Bit-for-bit consistent with the scalar ``estimate``/``cheap_objectives``
    reference path (tests/test_cost_backend_parity.py), with or without a
    shared evaluation context.
    """

    def __init__(self, profile: HardwareProfile = FPGA_ZU):
        self.profile = profile
        self.platform = profile.name
        self.name = f"fpga_analytic[{profile.name}]"
        self.schema = ObjectiveSchema.cheap(self.platform)

    def evaluate_batch(self, enc: PopulationEncoding, *,
                       space: SearchSpace = DEFAULT_SPACE,
                       shared: Optional[SharedPopulationEval] = None
                       ) -> np.ndarray:
        if shared is None:
            shared = SharedPopulationEval(population_layer_costs(enc, space))
        lo = batch_estimate(shared.costs, strategy="min",
                            profile=self.profile, shared=shared)
        hi = batch_estimate(shared.costs, strategy="max",
                            profile=self.profile, shared=shared)
        return np.stack([
            lo.p_total_w, hi.p_total_w,
            lo.e_total_j, hi.e_total_j,
            lo.latency_s, hi.latency_s,
            lo.params.astype(np.float64),
        ], axis=1)

    def evaluate(self, g: Genome, *,
                 space: SearchSpace = DEFAULT_SPACE) -> np.ndarray:
        enc = PopulationEncoding.from_genomes([g])
        return self.evaluate_batch(enc, space=space)[0]


class TPURooflineBackend:
    """Three-term roofline cost model (v5e constants) as a CostBackend.

    For genome scoring the mapping is deliberately simple (same altitude as
    Eq. 1-4 — good enough to rank candidates, DESIGN.md §2): the ``min``-α
    column models a fully folded datapath (one MAC per cycle); the ``max``-α
    column is the roofline bound over compute and HBM terms, with the implied
    parallelism driving the power model.
    """

    name = "tpu_roofline"
    platform = "tpu_roofline"

    def __init__(self, profile: HardwareProfile = TPU_V5E):
        self.profile = profile
        self.schema = ObjectiveSchema.cheap(self.platform)

    # ---- the shared pod-roofline helper (codesign + launch consume this)
    def roofline_terms(self, flops: float, bytes_hbm: float,
                       bytes_collective: float, chips: int) -> RooflineTerms:
        return roofline(flops, bytes_hbm, bytes_collective, chips)

    # ---- genome scoring --------------------------------------------------
    def evaluate_batch(self, enc: PopulationEncoding, *,
                       space: SearchSpace = DEFAULT_SPACE,
                       shared: Optional[SharedPopulationEval] = None
                       ) -> np.ndarray:
        if shared is None:
            shared = SharedPopulationEval(population_layer_costs(enc, space))
        costs = shared.costs
        macs = shared.mac_totals.astype(np.float64)
        params = shared.param_totals
        act_vals = np.where(costs.valid, costs.out_len * costs.out_channels,
                            0).sum(axis=1).astype(np.float64)
        w_bits = np.asarray(space.weight_bits, np.float64)[enc.w_bits]
        a_bits = np.asarray(space.act_bits, np.float64)[enc.a_bits]
        bytes_hbm = params * w_bits / 8.0 + act_vals * a_bits / 8.0

        p = self.profile
        lat_min = macs / p.f_clk  # fully folded: one MAC per cycle
        terms = self.roofline_terms(2.0 * macs, bytes_hbm, 0.0, chips=1)
        lat_max = np.maximum(terms.compute_s, terms.memory_s)
        alpha_eff = np.clip(lat_min / np.maximum(lat_max, 1e-30),
                            1.0, float(p.alpha_cap))
        p_min = np.full(len(enc),
                        p.p_static + p.p_idle_unit + p.p_calc_unit)
        p_max = p.p_static + alpha_eff * (p.p_idle_unit + p.p_calc_unit)
        return np.stack([
            p_min, p_max,
            lat_min * p_min, lat_max * p_max,
            lat_min, lat_max,
            params.astype(np.float64),
        ], axis=1)

    def evaluate(self, g: Genome, *,
                 space: SearchSpace = DEFAULT_SPACE) -> np.ndarray:
        enc = PopulationEncoding.from_genomes([g])
        return self.evaluate_batch(enc, space=space)[0]


class MultiPlatformBackend:
    """Score one population against K backends in a single call.

    The composite decodes and tabulates the population exactly once
    (:class:`~repro_torch.core.hw_model.SharedPopulationEval`) and hands the
    shared context to each member, so the per-member marginal cost is just
    the platform-specific Eq. 1-4 / roofline arithmetic — member columns
    are bit-identical to evaluating that member alone
    (tests/test_multi_platform.py).  The ``(N, K*7)`` result's ``schema``
    concatenates the members' platform-tagged column groups.
    """

    def __init__(self, backends: Sequence[BackendSpec]):
        if not backends:
            raise ValueError("MultiPlatformBackend needs >= 1 backend")
        members: List[CostBackend] = []
        for spec in backends:
            be = get_backend(spec)
            if isinstance(be, MultiPlatformBackend):
                members.extend(be.backends)   # flatten nested composites
            else:
                members.append(be)
        self.backends: tuple = tuple(members)
        # third-party backends may implement only the bare protocol
        # signature — the shared context is an optimization, not a contract
        self._accepts_shared = tuple(
            "shared" in inspect.signature(be.evaluate_batch).parameters
            for be in self.backends)
        # raises on duplicate platform tags — one column group per platform
        self.schema = ObjectiveSchema.concat(
            [backend_schema(be) for be in self.backends])
        self.name = "multi[" + "+".join(self.schema.platforms) + "]"

    def __len__(self) -> int:
        return len(self.backends)

    def evaluate_batch(self, enc: PopulationEncoding, *,
                       space: SearchSpace = DEFAULT_SPACE,
                       shared: Optional[SharedPopulationEval] = None
                       ) -> np.ndarray:
        if shared is None:
            shared = SharedPopulationEval(population_layer_costs(enc, space))
        return np.concatenate(
            [be.evaluate_batch(enc, space=space, shared=shared) if ok
             else be.evaluate_batch(enc, space=space)
             for be, ok in zip(self.backends, self._accepts_shared)],
            axis=1)

    def evaluate(self, g: Genome, *,
                 space: SearchSpace = DEFAULT_SPACE) -> np.ndarray:
        enc = PopulationEncoding.from_genomes([g])
        return self.evaluate_batch(enc, space=space)[0]


# Shared singleton: every pod-roofline consumer routes through this object.
TPU_ROOFLINE = TPURooflineBackend()

_ANALYTIC_CACHE: Dict[str, FPGAAnalyticBackend] = {}

BackendSpec = Union["CostBackend", HardwareProfile, str,
                    Sequence[Union["CostBackend", HardwareProfile, str]]]


def get_backend(spec: BackendSpec) -> CostBackend:
    """Resolve a backend instance, profile, name, or sequence thereof.

    Accepts a ready CostBackend (returned as-is), a
    :class:`HardwareProfile` (wrapped in a cached FPGAAnalyticBackend), a
    string (one of the profile names in ``PROFILES`` or ``"tpu_roofline"``),
    or a sequence of any of those (wrapped in a
    :class:`MultiPlatformBackend` — the multi-platform scoring pipeline).
    """
    if isinstance(spec, HardwareProfile):
        be = _ANALYTIC_CACHE.get(spec.name)
        if be is None or be.profile is not spec:
            be = FPGAAnalyticBackend(spec)
            _ANALYTIC_CACHE[spec.name] = be
        return be
    if isinstance(spec, str):
        if spec == TPU_ROOFLINE.name:
            return TPU_ROOFLINE
        if spec in PROFILES:
            return get_backend(PROFILES[spec])
        raise KeyError(f"unknown cost backend {spec!r} "
                       f"(profiles: {sorted(PROFILES)}, tpu_roofline)")
    if isinstance(spec, (list, tuple)):
        return MultiPlatformBackend(spec)
    if isinstance(spec, CostBackend):  # runtime-checkable structural match
        return spec
    raise TypeError(f"cannot resolve cost backend from {type(spec).__name__}")
