"""Hardware-aware objective models — paper §IV, Eqs. (1)-(4), plus the TPU
roofline model used at pod scale (DESIGN.md §2, "beyond-paper extension").

A copy of ``repro/core/hw_model.py`` (numpy only), imports repointed to
the port.

Latency (Eq. 1)::

    t_total = sum_j (n_in,j - 1) * sigma_{j-1} + l_j
    sigma_j = max(l_j, sigma_{j-1})           (pipelined output rate)

Power (Eqs. 2-3)::

    P_total = sum_i alpha_i * P*_idle,i + alpha_i * (t_a,i / t_total) * P*_calc,i

Energy (Eq. 4)::

    E_total = t_total * P_total

alpha_i are the per-layer unrolling (parallelization) factors.  P*_idle and
P*_calc are per-unrolling-unit idle/active power, which the paper estimates
with its FPGA profiler; we provide two calibration profiles:

* ``FPGA_ZU``  — Zynq-UltraScale-class constants, calibrated so Table I/II
  reproductions land in the paper's magnitude range (W, µJ).
* ``TPU_V5E``  — TPU-class constants (pJ/MAC at bf16/int8, 940 MHz), used
  when HALF's objective layer scores candidates for the TPU target.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.genome import Genome, PopulationEncoding
from repro_torch.core.search_space import DEFAULT_SPACE, SearchSpace
from repro_torch.hwlib.layers import (
    LayerCost,
    LayerCostArrays,
    OpCostTable,
    batch_layer_costs,
    layer_cost,
)

# ---------------------------------------------------------------------------
# Hardware profiles
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str
    f_clk: float          # Hz
    p_idle_unit: float    # W per unrolling unit, idling (P*_idle at alpha=1)
    p_calc_unit: float    # W per unrolling unit, computing (P*_calc at alpha=1)
    p_static: float       # W, design-independent static power (in P_total)
    p_board: float        # W, board/peripheral power (NOT in P_total; used
                          # for wall-energy reporting as the paper discusses)
    alpha_cap: int        # max unrolling units the platform can host (resource cap)

    def describe(self) -> str:
        return (f"{self.name}: f={self.f_clk/1e6:.0f}MHz "
                f"P*idle={self.p_idle_unit*1e3:.2f}mW "
                f"P*calc={self.p_calc_unit*1e3:.2f}mW cap={self.alpha_cap}")


# Calibrated so the ECG case study lands in the paper's ranges
# (Table I: 4.4-8.2 W, 841 uJ - 3.1 mJ, 1.4e3-4.8e5 samples/s).
FPGA_ZU = HardwareProfile(
    name="fpga_zu",
    f_clk=300e6,
    p_idle_unit=0.5e-3,
    p_calc_unit=3.0e-3,
    p_static=4.3,   # Table I's P_total floor: PS + PL static + clock trees
    p_board=4.0,
    alpha_cap=4096,
)

# Low-power small FPGA (Pynq-Z1-class, run at reduced clock as in Table II).
FPGA_PYNQ = HardwareProfile(
    name="fpga_pynq",
    f_clk=0.5e6,
    p_idle_unit=0.6e-3,
    p_calc_unit=4.0e-3,
    p_static=0.2,
    p_board=1.6,
    alpha_cap=512,
)

# Large FPGA (ZCU102-class) for the high-throughput domain.
FPGA_ZCU102 = HardwareProfile(
    name="fpga_zcu102",
    f_clk=322e6,
    p_idle_unit=1.1e-3,
    p_calc_unit=7.0e-3,
    p_static=0.8,
    p_board=8.0,
    alpha_cap=16384,
)

# TPU-class profile: one v5e MXU lane-group as the "unrolling unit".
TPU_V5E = HardwareProfile(
    name="tpu_v5e",
    f_clk=940e6,
    p_idle_unit=0.4e-3,
    p_calc_unit=2.2e-3,   # ~0.6 pJ/MAC bf16 + datapath overhead at 940 MHz
    p_static=25.0,
    p_board=60.0,
    alpha_cap=65536,
)

PROFILES = {p.name: p for p in (FPGA_ZU, FPGA_PYNQ, FPGA_ZCU102, TPU_V5E)}

# ---------------------------------------------------------------------------
# TPU pod roofline constants (assignment: v5e numbers)
# ---------------------------------------------------------------------------

PEAK_FLOPS_BF16 = 197e12      # FLOP/s per chip
HBM_BW = 819e9                # B/s per chip
ICI_BW = 50e9                 # B/s per link (we budget one link per chip —
                              # conservative; a 2D-torus axis has 2)


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """The three-term roofline for one compiled step on one mesh."""

    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes_hbm: float
    bytes_collective: float
    chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def roofline_fraction(self) -> float:
        """compute_term / max(all terms): 1.0 == perfectly compute-bound."""
        b = self.bound_s
        return self.compute_s / b if b > 0 else 0.0


def roofline(flops: float, bytes_hbm: float, bytes_collective: float,
             chips: int, peak_flops: float = PEAK_FLOPS_BF16,
             hbm_bw: float = HBM_BW, link_bw: float = ICI_BW
             ) -> RooflineTerms:
    """The three-term roofline of pod totals over ``chips``, by default
    with the v5e constants above (``launch/roofline.py`` passes the
    H100's)."""
    return RooflineTerms(
        compute_s=flops / (chips * peak_flops),
        memory_s=bytes_hbm / (chips * hbm_bw),
        collective_s=bytes_collective / (chips * link_bw),
        flops=flops, bytes_hbm=bytes_hbm,
        bytes_collective=bytes_collective, chips=chips,
    )


# ---------------------------------------------------------------------------
# Eq. (1): pipelined latency
# ---------------------------------------------------------------------------


def layer_costs_for(g: Genome, space: SearchSpace = DEFAULT_SPACE
                    ) -> List[LayerCost]:
    l, c = g.input_length(space), 2
    costs = []
    for spec in g.phenotype(space):
        cost = layer_cost(spec, l, c)
        costs.append(cost)
        l, c = cost.out_len, cost.out_channels
    return costs


def resolve_alphas(costs: Sequence[LayerCost], strategy: str,
                   profile: HardwareProfile) -> List[int]:
    """Map an implementation strategy to per-layer unrolling factors.

    * ``min``: alpha_i = 1 (fully folded — paper's min alpha_Impl).
    * ``max``: alpha_i = alpha_max_i, greedily capped by the platform's
      resource budget starting from the pipeline bottleneck (largest l_i),
      which is how the hardware generator allocates parallelism (§III-B).
    """
    if strategy == "min":
        return [1] * len(costs)
    if strategy != "max":
        raise ValueError(strategy)
    alphas = [1] * len(costs)
    budget = profile.alpha_cap - len(costs)
    # repeatedly unroll the current bottleneck stage
    for _ in range(10_000):
        lat = [c.l_cycles / a for c, a in zip(costs, alphas)]
        j = max(range(len(costs)), key=lambda i: lat[i])
        if alphas[j] >= costs[j].alpha_max:
            # bottleneck fully unrolled — unroll next-worst if budget remains
            rest = [i for i in range(len(costs)) if alphas[i] < costs[i].alpha_max]
            if not rest or budget <= 0:
                break
            j = max(rest, key=lambda i: lat[i])
        step = min(max(1, alphas[j]), costs[j].alpha_max - alphas[j], budget)
        if step <= 0:
            break
        alphas[j] += step
        budget -= step
    return alphas


def latency_cycles(costs: Sequence[LayerCost], alphas: Sequence[int]
                   ) -> Tuple[float, List[float]]:
    """Eq. (1) + the sigma recursion. Returns (t_total_cycles, sigmas)."""
    t_total = 0.0
    sigma_prev = 1.0  # input arrives at one value per cycle
    sigmas: List[float] = []
    for cost, a in zip(costs, alphas):
        l_j = cost.l_cycles / a
        t_total += (cost.n_in - 1) * sigma_prev + l_j
        sigma_prev = max(l_j, sigma_prev)
        sigmas.append(sigma_prev)
    return t_total, sigmas


def sample_runtime_cycles(costs: Sequence[LayerCost], alphas: Sequence[int]
                          ) -> float:
    """Pipeline fill (Eq. 1) + drain of the last layer's output stream —
    the steady-state per-sample runtime used for throughput/energy."""
    t_fill, sigmas = latency_cycles(costs, alphas)
    last = costs[-1]
    return t_fill + max(0, last.n_out - 1) * sigmas[-1]


# ---------------------------------------------------------------------------
# Eqs. (2)-(4): power and energy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HwEstimate:
    """Full analytic estimate for (genome, alphas, profile)."""

    t_total_s: float       # per-sample runtime (seconds)
    latency_s: float       # Eq. 1 pipeline latency (seconds)
    p_total_w: float       # Eq. 3 (+ static)
    e_total_j: float       # Eq. 4
    e_wall_j: float        # (P_total + P_board) * t_total — the measurable
    throughput_sps: float  # samples / s (pipelined: 1 sample per drain)
    params: int
    total_macs: int
    alphas: Tuple[int, ...]

    def objectives(self) -> dict:
        return {
            "latency_s": self.latency_s,
            "power_w": self.p_total_w,
            "energy_j": self.e_total_j,
        }


def estimate(g: Genome, *, strategy: str = "min",
             profile: HardwareProfile = FPGA_ZU,
             space: SearchSpace = DEFAULT_SPACE) -> HwEstimate:
    costs = layer_costs_for(g, space)
    alphas = resolve_alphas(costs, strategy, profile)
    t_lat, sigmas = latency_cycles(costs, alphas)
    t_cyc = sample_runtime_cycles(costs, alphas)
    t_s = t_cyc / profile.f_clk

    # Eq. 3 — per-layer active time t_a,i = n_out_i * l_i (cycles)
    p = profile.p_static
    for cost, a in zip(costs, alphas):
        l_i = cost.l_cycles / a
        t_a = cost.n_out * l_i
        duty = min(1.0, t_a / max(t_cyc, 1.0))
        p += a * profile.p_idle_unit + a * duty * profile.p_calc_unit

    # steady-state pipelined throughput: one sample every drain interval
    drain = max(1.0, max(0, costs[-1].n_out - 1) * sigmas[-1]
                + costs[-1].l_cycles / alphas[-1])
    # a new sample can enter once the bottleneck stage is free:
    bottleneck = max(c.l_cycles / a * c.n_out for c, a in zip(costs, alphas))
    interval = max(bottleneck, drain)
    thr = profile.f_clk / interval

    e = t_s * p  # Eq. 4
    return HwEstimate(
        t_total_s=t_s,
        latency_s=t_lat / profile.f_clk,
        p_total_w=p,
        e_total_j=e,
        e_wall_j=(p + profile.p_board) * t_s,
        throughput_sps=thr,
        params=sum(c.params for c in costs),
        total_macs=sum(c.total_macs for c in costs),
        alphas=tuple(alphas),
    )


# ---------------------------------------------------------------------------
# Batched population evaluation — the vectorized twin of the scalar path
# above (DESIGN.md §2).  Every reduction walks the layer axis in the same
# left-to-right order as the scalar loops so results match bit-for-bit.
# ---------------------------------------------------------------------------


def _bit_length(x: np.ndarray) -> np.ndarray:
    """Element-wise ``int.bit_length`` (exact for 0 <= x < 2**53)."""
    return np.frexp(x.astype(np.float64))[1]


@functools.lru_cache(maxsize=8)
def table_for_space(space: SearchSpace = DEFAULT_SPACE) -> OpCostTable:
    """Op catalogue + GAP/dense head sentinels as an :class:`OpCostTable`
    (ids ``n_ops`` and ``n_ops + 1`` — see PopulationEncoding.phenotype_ops)."""
    return OpCostTable.from_specs(tuple(space.ops) + space.head_specs())


def population_layer_costs(enc: PopulationEncoding,
                           space: SearchSpace = DEFAULT_SPACE
                           ) -> LayerCostArrays:
    """Batched :func:`layer_costs_for` over an encoded population."""
    ops, valid, _ = enc.phenotype_ops(space)
    return batch_layer_costs(table_for_space(space), ops, valid,
                             enc.input_lengths(space))


@dataclasses.dataclass(frozen=True)
class AlphaEventTable:
    """Budget-independent precomputation of :func:`batch_resolve_alphas`.

    Everything about the doubling-event merge except the platform's
    resource budget: per-layer event counts/first rounds, the boundary-round
    event order, and the closed-form round totals ``S(r)`` tabulated for
    every round.  One table serves every :class:`HardwareProfile` scoring
    the same population (``MultiPlatformBackend``): a profile's α factors
    then cost one ``(N, R)`` budget comparison plus the boundary-round
    step, instead of the full binary search (DESIGN.md §10).
    """

    k_count: np.ndarray   # (N, T) doubling events per layer
    d: np.ndarray         # (N, T) first round of each layer
    amax: np.ndarray      # (N, T) per-layer unrolling caps
    order: np.ndarray     # (N, T) boundary event order (M-desc, index-asc)
    s_table: np.ndarray   # (N, R) budget units consumed by rounds 0..r


def build_alpha_events(costs: LayerCostArrays) -> AlphaEventTable:
    """Tabulate the doubling-event structure of a population's layers.

    ``s_table[:, r]`` is the closed-form round total ``S(r)`` (the binary
    search's ``total_after``) evaluated for every round up front — R is
    small (≈ ``log2(alpha_cap)``-scale), so the full table costs a handful
    of ``(N, T)`` integer passes and then serves every profile's budget
    query as one comparison.
    """
    amax = costs.alpha_max
    n, t_pad = amax.shape
    m = np.maximum(costs.macs_per_out, 1)
    k_count = _bit_length(amax - 1)
    theta = m.max(axis=1, keepdims=True)
    d = _bit_length((theta - 1) // m)
    big_m = m << d                                # in [theta, 2*theta)
    # event order: M-descending, ties to the lower layer index.  Dead and
    # finished events carry step 0 at query time, so they are harmless
    # wherever they land — the order never depends on the budget.
    key = (2 * theta - big_m) * t_pad + np.arange(t_pad)
    order = np.argsort(key, axis=1)

    n_rounds = int((d + k_count).max(initial=0)) + 2
    s_table = np.empty((n, n_rounds), dtype=np.int64)
    for r in range(n_rounds):
        c = np.clip(r - d + 1, 0, k_count)
        s_table[:, r] = (np.minimum(np.left_shift(1, c), amax) - 1) \
            .sum(axis=1)
    return AlphaEventTable(k_count=k_count, d=d, amax=amax, order=order,
                           s_table=s_table)


def _resolve_max_from_events(costs: LayerCostArrays,
                             profile: HardwareProfile,
                             ev: AlphaEventTable) -> np.ndarray:
    """``max``-strategy α resolution against a precomputed event table.

    Identical factors to the binary-search path, layer for layer: both
    compute the exact crossing round ``min{r : S(r) > budget}`` (here a
    table lookup) and apply the same boundary-round prefix clip.
    """
    budget = (profile.alpha_cap - costs.n_layers).astype(np.int64)
    over = ev.s_table > budget[:, None]
    # rows that never cross the budget finish every event; any round past
    # the table leaves the boundary empty, matching the search's terminal lo
    lo = np.where(over.any(axis=1), over.argmax(axis=1),
                  ev.s_table.shape[1])
    c_prev = np.clip(lo[:, None] - ev.d, 0, ev.k_count)
    a_prev = np.minimum(np.left_shift(1, c_prev), ev.amax)
    b_rem = np.maximum(budget - (a_prev - 1).sum(axis=1), 0)
    k = lo[:, None] - ev.d
    alive = (k >= 0) & (k < ev.k_count)
    a_pre = np.left_shift(1, np.where(alive, k, 0))
    step = np.where(alive, np.minimum(a_pre, ev.amax - a_pre), 0)
    step_sorted = np.take_along_axis(step, ev.order, axis=1)
    cum = np.cumsum(step_sorted, axis=1)
    applied = np.clip(b_rem[:, None] - (cum - step_sorted), 0, step_sorted)
    np.put_along_axis(step, ev.order, applied, axis=1)
    return a_prev + step


class SharedPopulationEval:
    """Per-population intermediates shared across platform evaluations.

    ``MultiPlatformBackend`` decodes/tabulates a population once and hands
    this object to each member backend; the lazily cached pieces (α event
    table, fully-folded latency recursion, per-profile max-α factors) are
    bit-identical to what each backend would have computed alone.
    """

    def __init__(self, costs: LayerCostArrays):
        self.costs = costs
        self._max_alphas: dict = {}   # alpha_cap -> (N, T) factors

    @functools.cached_property
    def alpha_events(self) -> AlphaEventTable:
        return build_alpha_events(self.costs)

    @functools.cached_property
    def min_latency(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(t_total, sigmas)`` of the fully folded (α=1) datapath."""
        return _latency_from_ratio(self.costs, self.costs.l_cycles)

    def max_alphas(self, profile: HardwareProfile) -> np.ndarray:
        """Cached ``max``-strategy factors for one profile (resolved from
        the shared event table on first use).  The cache keys on the
        resource budget (``alpha_cap``) — the only profile field the
        resolution depends on."""
        cached = self._max_alphas.get(int(profile.alpha_cap))
        if cached is None:
            cached = _resolve_max_from_events(self.costs, profile,
                                              self.alpha_events)
            self._max_alphas[int(profile.alpha_cap)] = cached
        return cached

    @functools.cached_property
    def min_cycles(self) -> "MinCycleQuantities":
        """Profile-independent cycle-domain quantities of the fully folded
        (α=1) datapath, shared by every member's ``min``-strategy estimate."""
        return _min_cycle_quantities(self.costs, self.min_latency)

    @functools.cached_property
    def param_totals(self) -> np.ndarray:
        return np.where(self.costs.valid, self.costs.params, 0).sum(axis=1)

    @functools.cached_property
    def mac_totals(self) -> np.ndarray:
        return np.where(self.costs.valid, self.costs.total_macs, 0) \
            .sum(axis=1)


def batch_resolve_alphas(costs: LayerCostArrays, strategy: str,
                         profile: HardwareProfile,
                         events: Optional[AlphaEventTable] = None
                         ) -> np.ndarray:
    """Vectorized :func:`resolve_alphas`: ``(N, T)`` unrolling factors.

    The scalar ``max`` loop repeatedly steps the highest-latency layer that
    still has unrolling capacity (the "rest" branch merely skips exhausted
    layers), and each step at most doubles that layer's factor.  A layer's
    successive pick priorities ``l, l/2, l/4, ...`` are strictly decreasing,
    so the loop consumes the *descending merge of per-layer doubling
    events*: event ``(i, k)`` has priority ``l_i / 2^k`` and step size
    ``min(2^k, alpha_max_i - 2^k)`` (the final partial step to the cap),
    ties resolving to the lower layer index (first-max ``argmax``).

    That merge has closed *round* structure.  With ``Θ = max_i l_i`` and
    ``d_i = ceil(log2(Θ / l_i))``, event ``(i, k)`` lands in round
    ``r = k + d_i``; scaled priorities ``M_i = l_i · 2^{d_i} ∈ [Θ, 2Θ)``
    make every round's priority range ``[Θ/2^r, 2Θ/2^r)`` strictly above
    the next round's, and each layer appears at most once per round.  So:

    1. after ``r`` whole rounds, layer ``i`` has applied its first
       ``c_i(r) = clip(r - d_i + 1, 0, K_i)`` events, which telescope to
       ``min(2^{c_i}, alpha_max_i) - 1`` budget units — giving a closed-form
       monotone total ``S(r)``;
    2. the budget-crossing round ``r*`` (smallest ``r`` with
       ``S(r) > budget``) is found by a ~6-step vectorized binary search;
    3. inside round ``r*``, events run in ``M_i``-descending order (ties by
       layer index): one tiny ``(N, T)`` sort + cumulative clip applies the
       boundary, including the scalar loop's final partial budget step.

    All arithmetic is integer-exact (the scalar loop's float priority
    comparisons are exact too: integer MACs divided by powers of two), so
    the factors are identical to the scalar loop, genome for genome —
    enforced by tests/test_cost_backend_parity.py.

    The inline binary-search body below is the *reference twin* of the
    shared event-table fast path (:func:`_resolve_max_from_events`): the
    boundary-round block is intentionally duplicated between them, and
    tests/test_multi_platform.py pins the two to exact equality across
    every profile and tight-cap boundary case — edit one, sweep both.
    """
    n, t_pad = costs.l_cycles.shape
    if strategy == "min":
        return np.ones((n, t_pad), np.int64)
    if strategy != "max":
        raise ValueError(strategy)
    if events is not None:
        return _resolve_max_from_events(costs, profile, events)
    amax = costs.alpha_max
    budget = (profile.alpha_cap - costs.n_layers).astype(np.int64)
    m = np.maximum(costs.macs_per_out, 1)        # padded slots -> 1
    k_count = _bit_length(amax - 1)              # events per layer; 0 if
    theta = m.max(axis=1, keepdims=True)         # amax == 1 (padded slots)
    d = _bit_length((theta - 1) // m)            # first round of layer i

    def total_after(r):
        """S(r): budget units consumed by rounds 0..r, closed form."""
        c = np.clip(r - d + 1, 0, k_count)
        return (np.minimum(np.left_shift(1, c), amax) - 1).sum(axis=1)

    # binary search the crossing round r* = min{r : S(r) > budget}
    lo = np.zeros(n, np.int64)
    hi = np.full(n, int((d + k_count).max()) + 1, np.int64)
    for _ in range(max(1, int(hi[0]).bit_length())):
        mid = (lo + hi) >> 1
        over = total_after(mid[:, None]) > budget
        hi = np.where(over, mid, hi)
        lo = np.where(over, lo, mid + 1)

    # state after the last whole round (r* - 1)
    c_prev = np.clip(lo[:, None] - d, 0, k_count)
    a_prev = np.minimum(np.left_shift(1, c_prev), amax)
    b_rem = np.maximum(budget - (a_prev - 1).sum(axis=1), 0)

    # boundary round r*: at most one event per layer, M-descending order
    k = lo[:, None] - d
    alive = (k >= 0) & (k < k_count)
    a_pre = np.left_shift(1, np.where(alive, k, 0))
    step = np.where(alive, np.minimum(a_pre, amax - a_pre), 0)
    big_m = m << d                                # in [theta, 2*theta)
    key = (2 * theta - big_m) * t_pad + np.arange(t_pad)
    key[~alive] = np.iinfo(np.int64).max          # dead events sort last
    order = np.argsort(key, axis=1)
    step_sorted = np.take_along_axis(step, order, axis=1)
    cum = np.cumsum(step_sorted, axis=1)
    applied = np.clip(b_rem[:, None] - (cum - step_sorted), 0, step_sorted)
    np.put_along_axis(step, order, applied, axis=1)  # unsort in place
    return a_prev + step


def _latency_from_ratio(costs: LayerCostArrays, l_over_a: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
    n, t_pad = costs.l_cycles.shape
    t_total = np.zeros(n)
    sigma_prev = np.ones(n)  # input arrives at one value per cycle
    sigmas = np.zeros((n, t_pad))
    for t in range(t_pad):
        v = costs.valid[:, t]
        l_j = l_over_a[:, t]
        # parenthesized to round exactly like the scalar `t_total += ...`
        t_total = np.where(
            v, t_total + ((costs.n_in[:, t] - 1) * sigma_prev + l_j), t_total)
        sigma_prev = np.where(v, np.maximum(l_j, sigma_prev), sigma_prev)
        sigmas[:, t] = sigma_prev
    return t_total, sigmas


def batch_latency_cycles(costs: LayerCostArrays, alphas: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized Eq. (1): ``(t_total (N,), sigmas (N, T))``."""
    return _latency_from_ratio(costs, costs.l_cycles / alphas)


def batch_sample_runtime_cycles(costs: LayerCostArrays, alphas: np.ndarray
                                ) -> np.ndarray:
    """Vectorized :func:`sample_runtime_cycles` (fill + drain)."""
    t_fill, sigmas = batch_latency_cycles(costs, alphas)
    ar, last = np.arange(len(costs)), costs.last_index
    return t_fill + np.maximum(0, costs.n_out[ar, last] - 1) * sigmas[ar, last]


@dataclasses.dataclass(frozen=True)
class MinCycleQuantities:
    """Cycle-domain quantities of the fully folded (α=1) datapath.

    Everything here is independent of the :class:`HardwareProfile` (clock
    and power constants enter later), so one instance serves every platform
    scoring the same population (``SharedPopulationEval.min_cycles``).
    """

    t_lat: np.ndarray     # (N,) Eq. 1 pipeline latency, cycles
    sigmas: np.ndarray    # (N, T) output-rate recursion
    t_cyc: np.ndarray     # (N,) per-sample runtime (fill + drain), cycles
    duty: np.ndarray      # (N, T) per-layer duty fractions (Eq. 3)
    interval: np.ndarray  # (N,) steady-state sample interval, cycles


def _min_cycle_quantities(costs: LayerCostArrays,
                          min_latency: Tuple[np.ndarray, np.ndarray]
                          ) -> MinCycleQuantities:
    t_lat, sigmas = min_latency
    ar, last = np.arange(len(costs)), costs.last_index
    n_out_last = costs.n_out[ar, last]
    t_cyc = t_lat + np.maximum(0, n_out_last - 1) * sigmas[ar, last]
    duty = np.minimum(1.0, costs.n_out * costs.l_cycles
                      / np.maximum(t_cyc, 1.0)[:, None])
    drain = np.maximum(1.0, np.maximum(0, n_out_last - 1) * sigmas[ar, last]
                       + costs.l_cycles[ar, last])
    bottleneck = np.max(
        np.where(costs.valid, costs.l_cycles * costs.n_out, -np.inf), axis=1)
    return MinCycleQuantities(t_lat=t_lat, sigmas=sigmas, t_cyc=t_cyc,
                              duty=duty,
                              interval=np.maximum(bottleneck, drain))


@dataclasses.dataclass(frozen=True)
class BatchHwEstimate:
    """:class:`HwEstimate` for a whole population — every field an array."""

    t_total_s: np.ndarray       # (N,)
    latency_s: np.ndarray       # (N,)
    p_total_w: np.ndarray       # (N,)
    e_total_j: np.ndarray       # (N,)
    e_wall_j: np.ndarray        # (N,)
    throughput_sps: np.ndarray  # (N,)
    params: np.ndarray          # (N,) int64
    total_macs: np.ndarray      # (N,) int64
    alphas: np.ndarray          # (N, T) int64, padded slots == 1
    valid: np.ndarray           # (N, T) bool

    def __len__(self) -> int:
        return self.t_total_s.shape[0]

    def row(self, i: int) -> HwEstimate:
        """One genome's estimate as the scalar dataclass (for reporting)."""
        nl = int(self.valid[i].sum())
        return HwEstimate(
            t_total_s=float(self.t_total_s[i]),
            latency_s=float(self.latency_s[i]),
            p_total_w=float(self.p_total_w[i]),
            e_total_j=float(self.e_total_j[i]),
            e_wall_j=float(self.e_wall_j[i]),
            throughput_sps=float(self.throughput_sps[i]),
            params=int(self.params[i]),
            total_macs=int(self.total_macs[i]),
            alphas=tuple(int(a) for a in self.alphas[i, :nl]),
        )


def batch_estimate(costs: LayerCostArrays, *, strategy: str = "min",
                   profile: HardwareProfile = FPGA_ZU,
                   shared: Optional[SharedPopulationEval] = None
                   ) -> BatchHwEstimate:
    """Vectorized :func:`estimate` over pre-tabulated population costs.

    Pass ``shared`` (a :class:`SharedPopulationEval` over the same
    ``costs``) to reuse the platform-independent intermediates across
    several profiles — results are bit-identical either way.
    """
    n, t_pad = costs.l_cycles.shape
    ar = np.arange(n)
    last = costs.last_index
    if strategy == "min":
        # fully folded: every factor is 1 and the cycle-domain quantities
        # are profile-independent (sharable across platforms)
        alphas = np.ones((n, t_pad), np.int64)
        mc = shared.min_cycles if shared is not None else \
            _min_cycle_quantities(costs,
                                  _latency_from_ratio(costs, costs.l_cycles))
        t_lat, sigmas, t_cyc = mc.t_lat, mc.sigmas, mc.t_cyc
        duty_all, interval = mc.duty, mc.interval
    elif strategy == "max":
        alphas = shared.max_alphas(profile) if shared is not None \
            else batch_resolve_alphas(costs, strategy, profile)
        l_over_a = costs.l_cycles / alphas
        t_lat, sigmas = _latency_from_ratio(costs, l_over_a)
        n_out_last = costs.n_out[ar, last]
        t_cyc = t_lat + np.maximum(0, n_out_last - 1) * sigmas[ar, last]
        duty_all = np.minimum(1.0, costs.n_out * l_over_a
                              / np.maximum(t_cyc, 1.0)[:, None])
        drain = np.maximum(1.0, np.maximum(0, n_out_last - 1)
                           * sigmas[ar, last] + l_over_a[ar, last])
        bottleneck = np.max(
            np.where(costs.valid, l_over_a * costs.n_out, -np.inf), axis=1)
        interval = np.maximum(bottleneck, drain)
    else:
        raise ValueError(strategy)
    t_s = t_cyc / profile.f_clk

    # Eq. 3 — accumulated layer-by-layer in scalar order
    p = np.full(n, profile.p_static)
    for t in range(t_pad):
        v = costs.valid[:, t]
        a = alphas[:, t]
        p = np.where(v, p + (a * profile.p_idle_unit
                             + a * duty_all[:, t] * profile.p_calc_unit), p)

    thr = profile.f_clk / interval

    e = t_s * p  # Eq. 4
    if shared is not None:
        params_tot, macs_tot = shared.param_totals, shared.mac_totals
    else:
        params_tot = np.where(costs.valid, costs.params, 0).sum(axis=1)
        macs_tot = np.where(costs.valid, costs.total_macs, 0).sum(axis=1)
    return BatchHwEstimate(
        t_total_s=t_s,
        latency_s=t_lat / profile.f_clk,
        p_total_w=p,
        e_total_j=e,
        e_wall_j=(p + profile.p_board) * t_s,
        throughput_sps=thr,
        params=params_tot,
        total_macs=macs_tot,
        alphas=alphas,
        valid=costs.valid,
    )


def estimate_population(enc: PopulationEncoding, *, strategy: str = "min",
                        profile: HardwareProfile = FPGA_ZU,
                        space: SearchSpace = DEFAULT_SPACE) -> BatchHwEstimate:
    """Batched :func:`estimate`: decode + tabulate + Eq. 1-4 in one pass."""
    return batch_estimate(population_layer_costs(enc, space),
                          strategy=strategy, profile=profile)
