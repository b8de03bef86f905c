"""Routed mixture-of-experts with capacity-bounded dispatch.

Counterpart of ``repro/models/moe.py``: its sort path (``moe_block``) and
its expert-parallel path (``moe_block_ep``).  ``moe_block`` chooses as
the reference does: with ``cfg.moe_impl == "ep_a2a"``, a mesh and rules
installed (``axis_rules``), and a sequence length that divides the
``experts`` rule's mesh axis, it takes the EP path (:func:`_moe_block_ep`);
otherwise the sort path, on the whole batch (one device, or a DTensor
``x`` on a mesh: :func:`_moe_block_sharded`).  So on a mesh whose
experts axis has more than one rank a decode step (S 1) takes the sort
path, and on a one-rank axis every call takes EP.

The sort path:

1. top-k routing per token (ties to the lower expert id, as XLA's top_k);
2. stable-sort the (token, expert) pairs by expert id;
3. position-in-segment gives each pair a slot in a fixed ``(E, capacity,
   D)`` buffer; pairs past an expert's capacity are dropped (their
   contribution falls back to the residual stream);
4. the expert FFN: ``gmm`` (the hand-written grouped-matmul kernel on the
   card) for gate, up and down, where ``repro`` writes
   ``einsum('ecd,edf->ecf')``;
5. combine, weighted by the renormalised router gates.

On the card, ``repro``'s scatter-adds would be atomics, so bf16 sums would
change from run to run.  Here dispatch is an assignment (each kept slot
receives one row; dropped pairs go to a spare row past the buffer), and
the combine gathers each token's k rows and sums them over k in a fixed
order.  Nothing in the block syncs with the host: every capacity is a
Python int from shapes.  With :data:`repro_torch.trace.TRACER` on, each
call's per-expert pair counts (which the load-balance loss computes
anyway) are kept by reference, for a reader to count the pairs dropped
and the experts reached once the run is over.

Under a mesh (DTensor inputs) the sort path runs on local shards with the
reference's sort path's semantics, which are global: every rank holds the
whole token batch (an all-gather over the batch axes), routes it, sorts
it and bounds each expert at the capacity of the global token count, as
the one-device block does; each rank then runs ``gmm`` on its own experts
(the ``experts`` rule's axis) and combines their rows, so the output is a
sum over that axis (``Partial``), and the load-balance loss, which every
rank computes whole, is entered as its share of that sum.

The EP path keeps each token on its home rank (batch over the ``batch``
rule's axes, the sequence over the experts axis) and moves only routed
rows, in two all-to-alls over the experts axis: each rank routes its
tokens, bounds the pairs bound for each rank at ``c_send`` (in flat
(token, k) order), exchanges them with their local expert ids, bounds the
rows each local expert receives at ``c_loc`` (in arrival order: source
rank, then slot; an empty slot counts as local expert 0 there, as in the
reference), runs ``gmm`` on its experts, and sends the rows back to be
combined.  Its capacities are the reference's, per rank, so it drops
other pairs than the sort path: the two agree only where neither drops.
``c_loc`` can be 0 (kimi-k2's 384 experts on one rank below ~31 tokens):
every routed pair drops and only the shared expert, which runs outside
the exchange on the whole ``x``, contributes.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (
    current_mesh,
    current_rules,
    fit_placements,
    is_dtensor,
    local_call,
    logical_placements,
    mesh_axis_names,
    mesh_rank,
    placements_for,
)
from repro_torch.kernels.moe_gmm import gmm
from repro_torch.models import glue
from repro_torch.models.common import dense_init
from repro_torch.trace import TRACER


def init_moe(gen: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The reference's draws (fan-in truncated normals), each matrix cast
    to ``dtype`` as soon as it is drawn: one f32 expert matrix of
    dbrx-132b is 4.2 GB."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts

    def draw(shape, fan_in):
        return dense_init(gen, shape, fan_in).to(dtype)
    p = {
        "router": draw((d, e), d),
        "gate": draw((e, d, f), d),
        "up": draw((e, d, f), d),
        "down": draw((e, f, d), f),
    }
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        p["shared_gate"] = draw((d, fs), d)
        p["shared_up"] = draw((d, fs), d)
        p["shared_down"] = draw((fs, d), fs)
    return p


def moe_specs(cfg: ModelConfig, prefix: Tuple = ()) -> Dict[str, Tuple]:
    """Logical axis names of each MoE param, as ``repro``'s."""
    p = {
        "router": prefix + ("embed", None),
        "gate": prefix + ("experts", "embed", "expert_mlp"),
        "up": prefix + ("experts", "embed", "expert_mlp"),
        "down": prefix + ("experts", "expert_mlp", "embed"),
    }
    if cfg.n_shared_experts:
        p["shared_gate"] = prefix + ("embed", "mlp")
        p["shared_up"] = prefix + ("embed", "mlp")
        p["shared_down"] = prefix + ("mlp", "embed")
    return p


def expert_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    cap = math.ceil(n_tokens * cfg.experts_per_token / cfg.n_experts
                    * cfg.capacity_factor)
    return max(8, -(-cap // 8) * 8)  # round up to a multiple of 8


def route(p: Dict[str, torch.Tensor], xf: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xf: (T, D) -> (probs (T, E) f32, gates (T, k) f32 renormalised,
    experts (T, k) int64).  A stable descending sort keeps the lower
    expert id first among equal probabilities, as XLA's top_k does."""
    logits = (xf @ p["router"].to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    gates, experts = top[:, :k], experts[:, :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, experts


def moe_block(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar f32)."""
    mesh, rules = current_mesh(), current_rules()
    if (cfg.moe_impl == "ep_a2a" and mesh is not None and rules is not None
            and x.shape[1] % _mesh_sizes(mesh).get(
                rules.get("experts") or "", 1) == 0):
        return _moe_block_ep(p, x, cfg, mesh, rules)
    if is_dtensor(x):
        return _moe_block_sharded(p, x, cfg)
    return _moe_block(p, x, cfg)


def _mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh (or of a ``{name: size}``)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh_axis_names(mesh), mesh.shape))


def _moe_block_sharded(p: Dict[str, torch.Tensor], x: torch.Tensor,
                       cfg: ModelConfig
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim
    w_pl = {k: logical_placements(p[k].shape, ("experts", None, None), mesh)
            for k in ("gate", "up", "down")}
    e_rank, e_ways = mesh_rank(mesh, w_pl["gate"], 0)
    # the output and the aux loss: summands over the experts' axis
    out_pl = [Partial() if isinstance(pl, Shard) else Replicate()
              for pl in w_pl["gate"]]
    keys = sorted(p)

    def local(xl, *leaves):
        y, aux = _moe_block(dict(zip(keys, leaves)), xl, cfg,
                            experts=(e_rank, e_ways))
        return y, aux / e_ways
    return local_call(local, (x, *(p[k] for k in keys)),
                      (rep, *(w_pl.get(k, rep) for k in keys)),
                      (out_pl, out_pl))


def _moe_block(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
               experts: Tuple[int, int] = (0, 1)
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block over the whole batch ``x``; ``experts = (i, n)``: ``p``'s
    expert matrices are the i-th of n equal slices of the experts, and the
    output sums only theirs."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    t = b * s
    xf = x.reshape(t, d)
    probs, gates, experts_of = route(p, xf, cfg)

    # Switch-style load-balance auxiliary loss; counts by comparison, not
    # by scatter, so the block stays free of atomics.
    flat_e = experts_of.reshape(-1)                         # (T*k,)
    counts = (flat_e[:, None] == torch.arange(e, device=x.device)).sum(0)
    aux = e * torch.sum(probs.mean(dim=0) * (counts.float() / (t * k)))

    # ---- sort-based dispatch -------------------------------------------
    # kept: within capacity and one of the experts held here, [e0, e0+el)
    cap = expert_capacity(t, cfg)
    if TRACER.on:   # the pairs each expert drew, read after the run
        TRACER.moe(counts, cap, t)
    el = e // experts[1]
    e0 = experts[0] * el
    order, sorted_e, pos, keep = _dispatch_local(
        flat_e, e, cap, (flat_e >= e0) & (flat_e < e0 + el))
    # each kept pair's row of the flattened (el*cap, D) buffer; the other
    # pairs all land on the spare row el*cap
    slot = torch.where(keep, (sorted_e - e0) * cap + pos, el * cap)
    buf = _assign(slot, xf[order // k], el * cap).view(el, cap, d)

    # ---- expert FFN (the moe_gmm contraction) ---------------------------
    h = glue.swiglu(gmm(buf, p["gate"].to(x.dtype)),
                    gmm(buf, p["up"].to(x.dtype)), cfg)
    out_buf = gmm(h, p["down"].to(x.dtype)).view(el * cap, d)

    # ---- combine: each pair's row in (token, k) order, summed over k ---
    vals = _gather(out_buf, _inverse(order, slot))          # (T*k, D)
    y = (vals * gates.reshape(-1, 1).to(x.dtype)).view(t, k, d).sum(dim=1)

    if cfg.n_shared_experts and experts[0] == 0:   # once in the sum
        hs = glue.swiglu(xf @ p["shared_gate"].to(x.dtype),
                         xf @ p["shared_up"].to(x.dtype), cfg)
        y = y + hs @ p["shared_down"].to(x.dtype)
    return y.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# Dispatch by stable sort (both paths); expert parallelism: two
# all-to-alls over the experts axis
# ---------------------------------------------------------------------------


def _dispatch_local(ids: torch.Tensor, n_buckets: int, capacity: int,
                    valid: Optional[torch.Tensor] = None):
    """Stable-sort (row -> bucket) assignment with per-bucket capacity:
    (order, bucket of each sorted row, its slot (0 where dropped), keep).
    Each bucket keeps its first ``capacity`` rows in ``ids``' order; rows
    where ``valid`` is False take their places but are not kept (the
    reference's ``keep2 & valid``)."""
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order]
    seg_start = torch.searchsorted(
        sorted_ids, torch.arange(n_buckets, device=ids.device,
                                 dtype=sorted_ids.dtype))
    pos = torch.arange(ids.numel(), device=ids.device) - seg_start[sorted_ids]
    keep = pos < capacity
    if valid is not None:
        keep = keep & valid[order]
    return order, sorted_ids, torch.where(keep, pos, 0), keep


def _assign(rows: torch.Tensor, vals: torch.Tensor, n: int,
            fill: float = 0) -> torch.Tensor:
    """An (n, ...) buffer of ``fill`` with ``vals[i]`` written to row
    ``rows[i]``; rows ``n`` (the dropped ones) go to a spare row, cut off.
    Kept rows are distinct, so this is an assignment, not a sum."""
    buf = vals.new_full((n + 1, *vals.shape[1:]), fill)
    buf.index_put_((rows,), vals)
    return buf[:n]


def _gather(buf: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``buf``'s rows at ``rows``; row ``len(buf)`` (a dropped pair's)
    reads zeros, also from an empty ``buf`` (capacity 0)."""
    n = buf.shape[0]
    if n == 0:
        return buf.new_zeros((rows.numel(), *buf.shape[1:]))
    kept = rows < n
    return torch.where(kept[:, None], buf[torch.where(kept, rows, 0)], 0)


def _inverse(order: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``rows`` (given in sorted order) back in the order before the sort
    (``order`` is a permutation: a scatter without repeats)."""
    return torch.empty_like(rows).scatter_(0, order, rows)


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Chunk j of ``t``'s rows to rank j of ``group``; chunk j of the
    result from rank j (``lax.all_to_all(split_axis=0, concat_axis=0)``).
    Its gradient is the all-to-all back."""
    from torch.distributed import _functional_collectives as funcol
    if t.is_floating_point():
        out = funcol.all_to_all_single_autograd(t, None, None, group)
    else:
        out = funcol.all_to_all_single(t, None, None, group)
    return funcol.wait_tensor(out)


class _PMean(torch.autograd.Function):
    """The mean of a tensor over the ranks of ``groups`` (``lax.pmean``):
    a sum over each group in turn, over their number of ranks.  The result
    is the same on every rank and so is its cotangent, so each rank's
    share of the gradient is that cotangent over the number of ranks."""

    @staticmethod
    def forward(ctx, t, groups):
        from torch.distributed import _functional_collectives as funcol
        ctx.n = 1
        for g in groups:
            t = funcol.wait_tensor(funcol.all_reduce(t, "sum", g))
            ctx.n *= g.size()
        return t / ctx.n

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.n, None


def _moe_block_ep(p: Dict[str, torch.Tensor], x: torch.Tensor,
                  cfg: ModelConfig, mesh, rules
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE (``repro``'s ``moe_block_ep``). x: (B, S, D) on
    ``mesh`` (a plain ``x`` is taken as the same on every rank, and the
    outputs are then plain too).  x is split over the batch axes (each
    that divides B) and its sequence over the experts axis; each rank
    routes its own tokens and runs ``gmm`` on its own experts.  The output
    is placed as x; the load-balance loss is the reference's, from means
    over the ranks, the same on every rank."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distributed.sharding import P

    if isinstance(mesh, dict):
        raise ValueError("the EP MoE path needs a DeviceMesh, not a map of "
                         "axis sizes")
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token

    def axes(name):
        v = rules.get(name)
        return () if v is None else (v,) if isinstance(v, str) else tuple(v)

    names = mesh_axis_names(mesh)
    model_ax = (axes("experts") or (None,))[0]
    if model_ax not in names:
        raise ValueError(f"the experts rule {rules.get('experts')!r} names "
                         f"no axis of the mesh {names}")
    n_model = mesh.size(names.index(model_ax))
    if e % n_model:
        raise ValueError(f"{e} experts do not split over {n_model} ranks")
    e_loc = e // n_model
    batch_axes = tuple(a for a in axes("batch")
                       if a in names and a != model_ax)
    rep = [Replicate()] * mesh.ndim
    x_pl = fit_placements(placements_for(
        P(batch_axes or None, model_ax, None), mesh), x.shape, mesh)
    split = [names[m] for m, pl in enumerate(x_pl) if isinstance(pl, Shard)]
    n_batch = math.prod(mesh.size(m) for m, pl in enumerate(x_pl)
                        if pl == Shard(0))
    # per-rank token count and the reference's two capacities
    t_loc = (b // n_batch) * (s // n_model)
    c_send = -(-int(t_loc * k / n_model * cfg.capacity_factor) // 8) * 8
    c_loc = -(-int(n_model * c_send / e_loc * cfg.capacity_factor) // 8) * 8
    # experts over the experts axis, whole elsewhere: local_call gathers
    # the FSDP shards (and reduce-scatters their gradient)
    w_pl = placements_for(P(model_ax, None, None), mesh)
    group = mesh.get_group(model_ax)
    mean_groups = [mesh.get_group(a) for a in split]

    def local(xl, router, gate, up, down):
        return _ep_local({"router": router, "gate": gate, "up": up,
                          "down": down}, xl, cfg, (n_model, e_loc),
                         (c_send, c_loc), group, mean_groups)

    xd = x if is_dtensor(x) else DTensor.from_local(x, mesh, rep,
                                                    run_check=False)
    y, aux = local_call(local, (xd, p["router"], p["gate"], p["up"],
                                p["down"]),
                        (x_pl, rep, w_pl, w_pl, w_pl), (x_pl, rep))
    # back to x's placements (a sequence split over the experts axis is
    # gathered; a sum is whole), so the block's output is placed as x
    y = y.redistribute(mesh, [Replicate() if pl.is_partial() else pl
                              for pl in xd.placements])
    if cfg.n_shared_experts:
        hs = glue.swiglu(xd @ p["shared_gate"].to(x.dtype),
                         xd @ p["shared_up"].to(x.dtype), cfg)
        y = y + hs @ p["shared_down"].to(x.dtype)
    if not is_dtensor(x):
        return y.full_tensor(), aux.full_tensor()
    return y, aux


def _ep_local(p: Dict[str, torch.Tensor], xb: torch.Tensor,
              cfg: ModelConfig, ranks: Tuple[int, int],
              caps: Tuple[int, int], group, mean_groups
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's EP block: xb (B_loc, S_loc, D) its tokens, ``p`` the
    router and its ``e_loc`` experts' matrices, ``ranks`` (n_model,
    e_loc), ``caps`` (c_send, c_loc); the all-to-alls over ``group``, the
    load-balance means over ``mean_groups``."""
    n_model, e_loc = ranks
    c_send, c_loc = caps
    e, k = cfg.n_experts, cfg.experts_per_token
    d = xb.shape[-1]
    xf = xb.reshape(-1, d)
    t = xf.shape[0]
    probs, gates, experts = route(p, xf, cfg)
    flat_e = experts.reshape(-1)                            # (T_loc*k,)
    counts = (flat_e[:, None] == torch.arange(e, device=xb.device)).sum(0)
    aux = e * torch.sum(_PMean.apply(probs.mean(dim=0), mean_groups)
                        * _PMean.apply(counts.float() / (t * k),
                                       mean_groups))

    # ---- to the rank that holds each pair's expert (at most c_send each)
    order, dest_s, slot_s, keep_s = _dispatch_local(
        flat_e // e_loc, n_model, c_send)
    rows = torch.where(keep_s, dest_s * c_send + slot_s, n_model * c_send)
    send = _assign(rows, xf[order // k], n_model * c_send)
    send_exp = _assign(rows, (flat_e[order] % e_loc).to(torch.int32),
                       n_model * c_send, fill=-1)
    recv = _all_to_all(send, group)                # (n_model * c_send, D)
    recv_exp = _all_to_all(send_exp, group)        # its local expert or -1

    # ---- to each local expert's buffer (at most c_loc each); an empty
    # slot sorts as expert 0 and takes a place there, as in the reference
    valid = recv_exp >= 0
    order2, exp_s, slot2, keep2 = _dispatch_local(
        torch.where(valid, recv_exp, 0).long(), e_loc, c_loc, valid)
    rows2 = torch.where(keep2, exp_s * c_loc + slot2, e_loc * c_loc)
    ebuf = _assign(rows2, recv[order2], e_loc * c_loc).view(e_loc, c_loc, d)

    h = glue.swiglu(gmm(ebuf, p["gate"].to(xb.dtype)),
                    gmm(ebuf, p["up"].to(xb.dtype)), cfg)
    obuf = gmm(h, p["down"].to(xb.dtype)).view(e_loc * c_loc, d)

    # ---- back to the home ranks, then each token's k rows by its gates
    back = _gather(obuf, _inverse(order2, rows2))
    ret = _all_to_all(back, group)
    got = _gather(ret, _inverse(order, rows))               # (T_loc*k, D)
    y = (got * gates.reshape(-1, 1).to(xb.dtype)).view(t, k, d).sum(dim=1)
    return y.view(xb.shape), aux
