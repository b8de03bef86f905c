"""HALF's cross-layer loop applied to TPU implementation parameters.

The paper's method: explore topology/implementation choices against CHEAP
analytic platform models (Eqs. 1-4), keep the Pareto frontier, spend
expensive evaluation only on frontier candidates.  Here the "topology" is a
fixed zoo config and the genome is the *implementation*: microbatch count,
causal q-blocking, MoE execution strategy, remat policy — the same knobs
the §Perf hillclimb tuned by hand.  The cheap objective is an analytic
three-term roofline (calibrated against the measured dry-run cells), and
"expensive evaluation" is an actual ``dryrun.run_cell`` compile.

``examples/codesign_tpu.py`` demonstrates that the analytic frontier
reproduces the hillclimb's adopted configuration for kimi-k2 without a
single compile — HALF's central claim (hardware-aware search finds the
hand-tuned point automatically), transplanted to the pod.

A copy of ``repro/core/tpu_codesign.py`` (numpy only), imports repointed
to the port.  It scores a TPU v5e pod *as a search target* through the
port's ``TPU_ROOFLINE`` (``hw_model.TPU_V5E``'s constants), as
``cost_backend.py`` does: its numbers are cost-model data, not
measurements of the card the port runs on.  The port's own dry run
(``launch/dryrun.py``) takes the H100's constants instead
(``launch/roofline.py``).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeCell
from repro_torch.core.cost_backend import TPU_ROOFLINE
from repro_torch.core.pareto import pareto_front


@dataclasses.dataclass(frozen=True)
class ImplGenome:
    """Implementation-layer genes (the TPU analogue of HALF's alpha/quant)."""

    microbatches: int = 1
    n_q_blocks: int = 8          # causal q-blocking factor (1 = off)
    moe_impl: str = "sort"       # sort | ep_a2a
    remat: str = "full"          # full | dots

    def short(self) -> str:
        return (f"mb{self.microbatches}-qb{self.n_q_blocks}-"
                f"{self.moe_impl}-{self.remat}")


SEARCH_SPACE = {
    "microbatches": (1, 2, 4, 8, 16),
    "n_q_blocks": (1, 4, 8, 16),
    "moe_impl": ("sort", "ep_a2a"),
    "remat": ("full", "dots"),
}


@dataclasses.dataclass
class CostEstimate:
    compute_s: float
    memory_s: float
    collective_s: float
    act_gib: float               # activation live-set per device

    def vector(self) -> np.ndarray:
        return np.asarray([self.compute_s, self.memory_s,
                           self.collective_s, self.act_gib])

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def estimate_train_cell(cfg: ModelConfig, cell: ShapeCell, g: ImplGenome,
                        mesh_shape: Dict[str, int]) -> CostEstimate:
    """Analytic three-term roofline for a train step under genome ``g``.

    Deliberately simple closed forms — the same altitude as the paper's
    Eqs. 1-4: good enough to RANK implementation points, cross-checked
    against the reference's measured dry-run cells (test_tpu_codesign.py).
    """
    chips = int(np.prod(list(mesh_shape.values())))
    n_data = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    n_model = mesh_shape.get("model", 1)
    tokens = cell.global_batch * cell.seq_len
    d, L = cfg.d_model, cfg.n_layers
    n_active = cfg.active_param_count()
    n_embed = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    n_body = max(n_active - n_embed, 1)

    # ---- compute ---------------------------------------------------------
    remat_mult = 8.0 / 6.0 if g.remat == "full" else 6.5 / 6.0
    param_flops = 6.0 * n_body * tokens * remat_mult
    causal_frac = (g.n_q_blocks + 1) / (2 * g.n_q_blocks)
    h, hd = max(cfg.n_heads, 1), cfg.resolved_head_dim
    attn_flops = (12.0 * cell.global_batch * cell.seq_len ** 2 * h * hd
                  * causal_frac * (1.5 if g.remat == "full" else 1.0)
                  ) if cfg.n_heads else 0.0
    embed_flops = 6.0 * tokens * d * cfg.vocab_size
    flops = param_flops + attn_flops + embed_flops

    # ---- memory (ideal-fusion altitude) ------------------------------------
    # weights traffic: every microbatch re-reads the (sharded) weights
    w_bytes = 2.0 * n_active / chips * 3 * g.microbatches  # fwd+bwd+remat
    act_row = tokens // n_data * d * 2  # one (B_loc, S, D) bf16 tensor
    resid_stack = L * act_row / g.microbatches
    act_traffic = L * act_row * (12 if g.remat == "full" else 9)
    logits_traffic = 6.0 * tokens // n_data * cfg.vocab_size \
        / (n_model if cfg.vocab_size % n_model == 0 else 1)
    bytes_hbm = w_bytes + act_traffic + logits_traffic

    # ---- collectives -------------------------------------------------------
    # TP all-reduce: 2 per layer fwd + 2 bwd, f32 on this backend
    tp_ar = L * 4 * (tokens // n_data) * d * 4
    # FSDP weight AG + grad RS per microbatch
    fsdp = 2.0 * n_active / n_model * 2 * g.microbatches / n_data
    moe = 0.0
    if cfg.n_experts:
        t_loc = tokens // n_data // g.microbatches
        if g.moe_impl == "ep_a2a":
            moe = (L * 4 * t_loc / n_model * cfg.experts_per_token
                   * d * 2 * g.microbatches * cfg.capacity_factor)
        else:  # pjit sort dispatch: measured ~full (T, D) f32 AR per layer
            moe = L * 4 * t_loc * d * 4 * g.microbatches
    bytes_coll = tp_ar + fsdp + moe

    # memory/collective quantities above are PER DEVICE; the shared backend
    # takes pod totals, so scale up and let it normalize back per chip.
    terms = TPU_ROOFLINE.roofline_terms(
        flops, bytes_hbm * chips, bytes_coll * chips, chips)

    # ---- activation live set ------------------------------------------------
    act_gib = (resid_stack + 2 * act_row / g.microbatches
               * (3 if g.remat == "dots" else 1)) / 2 ** 30
    return CostEstimate(terms.compute_s, terms.memory_s, terms.collective_s,
                        act_gib)


def enumerate_frontier(cfg: ModelConfig, cell: ShapeCell,
                       mesh_shape: Dict[str, int]
                       ) -> Tuple[List[ImplGenome], List[CostEstimate],
                                  np.ndarray]:
    """Exhaustive cheap evaluation + Pareto frontier (HALF step 1).

    The space is small enough to enumerate; the paper's evolutionary
    machinery matters when it is not — both share the Pareto selection.
    """
    genomes, costs = [], []
    for mb, qb, mi, rm in itertools.product(*SEARCH_SPACE.values()):
        if mi == "ep_a2a" and not cfg.n_experts:
            continue
        if cell.global_batch % mb:
            continue
        g = ImplGenome(mb, qb, mi, rm)
        genomes.append(g)
        costs.append(estimate_train_cell(cfg, cell, g, mesh_shape))
    pts = np.stack([c.vector() for c in costs])
    front = pareto_front(pts)
    return genomes, costs, front


def best_by_bound(genomes: List[ImplGenome], costs: List[CostEstimate],
                  front: np.ndarray, max_act_gib: float = 16.0
                  ) -> Tuple[ImplGenome, CostEstimate]:
    """Deployment selection (HALF step 2): min roofline bound on the
    frontier subject to the activation-memory constraint."""
    feas = [i for i in front if costs[i].act_gib <= max_act_gib] or \
        list(front)
    i = min(feas, key=lambda j: costs[j].bound_s)
    return genomes[i], costs[i]
