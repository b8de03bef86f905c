"""Decoder-only LM: dense, MoE and VLM families.

Counterpart of ``repro/models/transformer.py``.  The reference stacks layer
parameters on a leading ``layers`` axis for ``lax.scan``; PyTorch runs
eagerly, so here ``params["layers"]`` is a list of per-layer dicts and the
scan is a Python loop.  KV caches keep the reference's stacked layout,
``(layers, batch, cache_len, kv_heads, head_dim)``, and decode writes each
layer's slice of it in place.  The reference's ``logical_constraint``
sharding hints stand where the reference's do: under a mesh they
redistribute the residual stream and the logits (DTensors) to the rules'
placements, and without one they do nothing.  The embedding lookup runs
on local shards under a mesh: the table all-gathered, each rank looking
up its own rows of the batch.

Entry points: ``lm_forward`` (training), ``lm_prefill`` / ``lm_decode_step``
(one shared length), their ``_slotted`` forms (per-slot lengths, the
serving engine's dense path) and their ``_paged`` forms (a block pool
shared by every slot, the paged engine's path).  An MoE layer holds
``moe`` where a dense one holds ``mlp``; training sums the layers' load-
balance losses, serving discards them, as the reference does.  The VLM
family (qwen2-vl) is the dense one fed precomputed ``embeds`` (its vision
frontend is a stub in the reference too) at M-RoPE ``positions`` (3, B,
S); it has no slotted or paged prefill, whose prompts are token ids.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.distributed.sharding import (
    is_dtensor,
    local_call,
    logical_constraint,
    logical_placements,
)
from repro_torch.models.attention import (
    attention_block,
    attention_decode,
    attention_decode_paged,
    attention_decode_slotted,
    attention_prefill,
    attention_specs,
    init_attention,
    paged_pool,
    paged_write,
)
from repro_torch.models.common import (
    apply_norm,
    cast_tree,
    embed_init,
    init_norm,
    norm_specs,
    remat_call,
)
from repro_torch.models.mlp import init_mlp, mlp_block, mlp_specs
from repro_torch.models.moe import init_moe, moe_block, moe_specs


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(
            f"family {cfg.family!r} is not a family of this module (it "
            f"serves the dense, MoE and VLM LM families; ssm and hybrid are "
            f"models/hybrid.py, encdec models/encdec.py)")


def check_token_prompts(cfg: ModelConfig) -> None:
    """The slotted and paged prefill take token prompts at arange
    positions; an M-RoPE model's prompts are embeddings at (3, B, S)
    positions.  The reference's slotted prefill fails there with an
    IndexError (its RoPE indexes (B, S) positions); this refuses first."""
    if cfg.mrope:
        raise ValueError(
            f"{cfg.name}: the slotted and paged prefill take token prompts "
            f"at (B, S) positions; an M-RoPE ({cfg.family}) model needs "
            f"(3, B, S) positions and embeddings: use prefill and "
            f"decode_step")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_layer(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype
                ) -> Dict[str, Any]:
    p = {
        "attn_norm": init_norm(cfg.norm, cfg.d_model, gen.device),
        "attn": init_attention(gen, cfg),
        "mlp_norm": init_norm(cfg.norm, cfg.d_model, gen.device),
    }
    if cfg.family == "moe":
        p["moe"] = init_moe(gen, cfg, dtype)
    else:
        p["mlp"] = init_mlp(gen, cfg)
    return p


def init_lm(seed: int, cfg: ModelConfig, device: DeviceLike = None
            ) -> Dict[str, Any]:
    """Random weights from a seeded ``torch.Generator`` on ``device``.

    Same distributions as the reference's ``init_lm`` (truncated normals,
    unit norms, zero biases, everything cast to ``cfg.dtype``), not the
    same numbers: parity tests copy the reference's params instead
    (:func:`repro_torch.weights.params_from_jax`).  Each layer is cast as
    soon as it is drawn (each expert matrix as soon as it is drawn), so f32
    copies of the whole model never coexist.
    """
    check_family(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model)).to(dtype),
        "layers": [cast_tree(_init_layer(gen, cfg, dtype), dtype)
                   for _ in range(cfg.n_layers)],
        "final_norm": cast_tree(init_norm(cfg.norm, cfg.d_model, dev), dtype),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(
            gen, (cfg.d_model, cfg.vocab_size)).to(dtype)
    return params


def lm_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """Logical axis names of :func:`init_lm`'s params: ``repro``'s leaf for
    leaf, without its stacked ``layers`` prefix (``layers`` is a list
    here)."""
    lp: Dict[str, Any] = {
        "attn_norm": norm_specs(cfg.norm),
        "attn": attention_specs(cfg),
        "mlp_norm": norm_specs(cfg.norm),
    }
    if cfg.family == "moe":
        lp["moe"] = moe_specs(cfg)
    else:
        lp["mlp"] = mlp_specs(cfg)
    specs: Dict[str, Any] = {
        "embed": ("vocab", "embed_unsharded"),
        "layers": [lp] * cfg.n_layers,
        "final_norm": norm_specs(cfg.norm),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ("embed_unsharded", "vocab")
    return specs


# ---------------------------------------------------------------------------
# Layer body
# ---------------------------------------------------------------------------


def _ffn_residual(lp: Dict[str, Any], h: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``h`` plus the layer's feed-forward (dense MLP or MoE) of the normed
    ``h``, and the MoE load-balance loss (None for a dense layer)."""
    hn = apply_norm(cfg.norm, h, lp["mlp_norm"], cfg.norm_eps)
    if cfg.family == "moe":
        y, aux = moe_block(lp["moe"], hn, cfg)
        return h + y, aux
    return h + mlp_block(lp["mlp"], hn, cfg), None


def _mlp_residual(lp: Dict[str, Any], h: torch.Tensor, cfg: ModelConfig
                  ) -> torch.Tensor:
    return _ffn_residual(lp, h, cfg)[0]


def _attn_in(lp: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig
             ) -> torch.Tensor:
    return apply_norm(cfg.norm, x, lp["attn_norm"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def embedding_grad(ids: torch.Tensor, grad: torch.Tensor, n_rows: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """The (n_rows, D) gradient of ``table.index_select(0, ids)`` for the
    output gradient ``grad`` (len(ids), D), in ``dtype``, summed in an
    order that depends only on ``ids``: the rows are sorted by id (a stable
    sort, so each id keeps its token order), each id's rows are summed in
    f32 as a pairwise tree (round r adds the row 2^r positions on into
    every row whose rank in its run is a multiple of 2^(r+1)), and each sum
    is rounded once to ``dtype`` and gathered to its table row.  Every step
    is elementwise, a gather, a sort or an integer scan, so the result
    repeats bit for bit on the card, and equals the CPU's on equal inputs,
    where ``index_select``'s own backward adds rows with atomics."""
    n = ids.numel()
    if n == 0:
        return grad.new_zeros((n_rows, grad.shape[-1]), dtype=dtype)
    ids, perm = torch.sort(ids, stable=True)
    acc = grad.index_select(0, perm).float()
    pos = torch.arange(n, device=ids.device)
    new_run = torch.ones(n, dtype=torch.bool, device=ids.device)
    new_run[1:] = ids[1:] != ids[:-1]
    last = torch.ones_like(new_run)
    last[:-1] = new_run[1:]
    start = torch.cummax(torch.where(new_run, pos, 0), 0).values
    end = torch.cummin(torch.where(last, pos, n).flip(0), 0).values.flip(0)
    rank = pos - start
    step = 1
    while step < n:
        take = (rank % (2 * step) == 0) & (pos + step <= end)
        later = torch.cat([acc[step:], acc.new_zeros((step, acc.shape[1]))])
        acc = torch.where(take[:, None], acc + later, acc)
        step *= 2
    rows = torch.arange(n_rows, dtype=ids.dtype, device=ids.device)
    at = torch.searchsorted(ids, rows).clamp_(max=n - 1)
    found = ids[at] == rows
    out = acc.to(dtype).index_select(0, at)
    return out.masked_fill_(~found[:, None], 0)


class _Lookup(torch.autograd.Function):
    """``table.index_select(0, ids)`` whose backward is
    :func:`embedding_grad`."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows, ctx.dtype = table.shape[0], table.dtype
        return table.detach().index_select(0, ids)

    @staticmethod
    def backward(ctx, grad):
        ids, = ctx.saved_tensors
        return embedding_grad(ids, grad, ctx.rows, ctx.dtype), None


def _lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return _Lookup.apply(table, ids.reshape(-1)).reshape(*ids.shape, -1)


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    table = params["embed"]
    if is_dtensor(table):
        # the table replicated (an all-gather of its vocab shards), the ids
        # and rows split over the batch axes
        from torch.distributed.tensor import Replicate

        mesh = table.device_mesh
        ids_axes = ("batch",) + (None,) * (tokens.dim() - 1)
        ids_pl = logical_placements(tokens.shape, ids_axes, mesh)
        x = local_call(_lookup, (table, tokens),
                       ([Replicate()] * mesh.ndim, ids_pl), (ids_pl,))
    else:
        x = _lookup(table, tokens)
    return x.to(torch_dtype(cfg.dtype))


def _inputs(params, cfg: ModelConfig, tokens: Optional[torch.Tensor],
            embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """The first layer's input: ``embeds`` (B, S, D) where given (the VLM
    and audio stub frontends), else the lookup of ``tokens``."""
    if embeds is not None:
        return embeds.to(torch_dtype(cfg.dtype))
    return embed_tokens(params, tokens, cfg)


def unembed(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T.to(x.dtype)
    else:
        logits = x @ params["unembed"].to(x.dtype)
    return logical_constraint(logits, "batch", "seq", "vocab")


def _layer_fwd(lp: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
               positions: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    h = x + attention_block(lp["attn"], _attn_in(lp, x, cfg), cfg,
                            positions=positions, causal=True)
    h = logical_constraint(h, "batch", "seq", None)
    out, aux = _ffn_residual(lp, h, cfg)
    return logical_constraint(out, "batch", "seq", None), aux


def lm_hidden(params: Dict[str, Any], cfg: ModelConfig, *,
              tokens: Optional[torch.Tensor] = None,
              embeds: Optional[torch.Tensor] = None,
              positions: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backbone forward over ``tokens`` (B, S) or ``embeds`` (B, S, D) at
    ``positions`` (B, S), or (3, B, S) for M-RoPE (default: arange).
    Returns (final-norm hidden (B,S,D), aux_loss): the sum of the MoE
    layers' load-balance losses, a zero for the other families.  Where a
    gradient is taken each layer runs under ``cfg.remat``
    (:func:`remat_call`), as the reference's scan body."""
    check_family(cfg)
    x = logical_constraint(_inputs(params, cfg, tokens, embeds),
                           "batch", "seq", None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params["layers"]:
        x, aux_l = remat_call(cfg.remat, _layer_fwd, lp, x, cfg, positions)
        if aux_l is not None:
            aux = aux + aux_l
    x = apply_norm(cfg.norm, x, params["final_norm"], cfg.norm_eps)
    return x, aux


def lm_forward(params: Dict[str, Any], cfg: ModelConfig, *,
               tokens: Optional[torch.Tensor] = None,
               embeds: Optional[torch.Tensor] = None,
               positions: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward (inputs as :func:`lm_hidden`). Returns (logits (B,S,V),
    aux_loss)."""
    x, aux = lm_hidden(params, cfg, tokens=tokens, embeds=embeds,
                       positions=positions)
    return unembed(params, x, cfg), aux


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype: Optional[torch.dtype] = None,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Zero cache of one shared length; ``len`` is a Python int here (a
    device scalar would cost a host sync at every step that indexes with
    it)."""
    dtype = dtype or torch_dtype(cfg.dtype)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "len": 0}


def cache_specs(cfg: ModelConfig) -> Dict[str, Any]:
    kv = ("layers", "batch", None, "kv_heads", "head_dim")
    return {"k": kv, "v": kv, "len": ()}


def _prefill_layers(params, cfg: ModelConfig, x: torch.Tensor,
                    cache_len: int, positions: Optional[torch.Tensor]):
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    x = logical_constraint(x, "batch", "seq", None)
    for lp in params["layers"]:
        a, (kc, vc) = attention_prefill(lp["attn"], _attn_in(lp, x, cfg),
                                        cfg, cache_len, positions=positions)
        x = logical_constraint(_mlp_residual(lp, x + a, cfg),
                               "batch", "seq", None)
        ks.append(kc)
        vs.append(vc)
    return x, torch.stack(ks), torch.stack(vs)


def lm_prefill(params: Dict[str, Any], cfg: ModelConfig, *,
               tokens: Optional[torch.Tensor] = None,
               embeds: Optional[torch.Tensor] = None,
               positions: Optional[torch.Tensor] = None,
               cache_len: int) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Prefill pass (inputs as :func:`lm_hidden`): returns (last-token
    logits (B,V), populated cache).  The cache's ``len`` is the prompt's
    length, the next decode step's position (each M-RoPE component's too,
    as in the reference)."""
    check_family(cfg)
    x = _inputs(params, cfg, tokens, embeds)
    s = x.shape[1]
    x, k_all, v_all = _prefill_layers(params, cfg, x, cache_len, positions)
    x = apply_norm(cfg.norm, x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = unembed(params, x, cfg)[:, 0]
    return logits, {"k": k_all, "v": v_all, "len": s}


def init_slot_cache(cfg: ModelConfig, batch: int, cache_len: int,
                    dtype: Optional[torch.dtype] = None,
                    device: DeviceLike = None) -> Dict[str, Any]:
    """Slot-cache layout (serving engine): like :func:`init_cache` but with
    independent per-slot lengths ``lens: (batch,)`` int32 on the device."""
    cache = init_cache(cfg, batch, cache_len, dtype, device)
    del cache["len"]
    cache["lens"] = torch.zeros((batch,), dtype=torch.int32,
                                device=cache["k"].device)
    return cache


def lm_prefill_slotted(params: Dict[str, Any], cfg: ModelConfig, *,
                       tokens: torch.Tensor,   # (B, L) right-padded prompts
                       lens: torch.Tensor,     # (B,) true lengths (<= L)
                       cache_len: int) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Bucket prefill: prompts right-padded to a shared length ``L``.

    Causality keeps each row's first ``lens[b]`` positions independent of
    the pad tail, so the gathered last-real-token logits and the cache rows
    ``< lens[b]`` are exact; pad-tail KV rows hold garbage but stay masked
    because the slot's length is ``lens[b]``.  Returns per-row
    last-real-token logits ``(B, V)`` and a slot cache.  Refuses M-RoPE
    models (:func:`check_token_prompts`).
    """
    check_family(cfg)
    check_token_prompts(cfg)
    x = embed_tokens(params, tokens, cfg)
    x, k_all, v_all = _prefill_layers(params, cfg, x, cache_len, None)
    rows = torch.arange(x.shape[0], device=x.device)
    last = x[rows, lens.long() - 1][:, None]                   # (B, 1, D)
    last = apply_norm(cfg.norm, last, params["final_norm"], cfg.norm_eps)
    logits = unembed(params, last, cfg)[:, 0]
    return logits, {"k": k_all, "v": v_all, "lens": lens.to(torch.int32)}


def lm_decode_step_slotted(params: Dict[str, Any], cache: Dict[str, Any],
                           tokens: torch.Tensor,   # (B, 1)
                           active: torch.Tensor,   # (B,) bool
                           cfg: ModelConfig
                           ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step over every slot with independent lengths.

    Inactive slots still flow through the batch (their logits are ignored
    by the engine) but their length does not advance, so the next
    admission's prefill overwrites a clean slot.  ``cache["k"]`` and
    ``cache["v"]`` are written in place and returned in the new cache."""
    check_family(cfg)
    x = embed_tokens(params, tokens, cfg)
    lens = cache["lens"]
    for i, lp in enumerate(params["layers"]):
        a, _, _ = attention_decode_slotted(
            lp["attn"], _attn_in(lp, x, cfg), cache["k"][i], cache["v"][i],
            lens, cfg)
        x = _mlp_residual(lp, x + a, cfg)
    x = apply_norm(cfg.norm, x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params, x, cfg)[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"],
                    "lens": lens + active.to(torch.int32)}


def init_paged_cache(cfg: ModelConfig, slots: int, cache_len: int,
                     n_blocks: int, block_size: int,
                     dtype: Optional[torch.dtype] = None,
                     device: DeviceLike = None) -> Dict[str, Any]:
    """Paged cache layout: a pool of fixed-size KV blocks shared by every
    slot, plus per-slot block tables.

    ``k``/``v``: (layers, n_blocks, block_size, KVH, hd) pools, zeroed so
    unwritten positions hold finite values, and written in place by decode
    (each with spare blocks past it that inactive rows write:
    :func:`~repro_torch.models.attention.paged_pool`); ``tables``: (slots,
    cache_len // block_size) int32, the sentinel ``n_blocks`` marking
    unallocated entries; ``lens``: per-slot lengths."""
    if cache_len % block_size:
        raise ValueError(f"cache_len {cache_len} is not a multiple of "
                         f"block_size {block_size}")
    dtype = dtype or torch_dtype(cfg.dtype)
    dev = resolve_device(device)
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads,
             cfg.resolved_head_dim, slots, dtype, dev)
    return {
        "k": paged_pool(*shape),
        "v": paged_pool(*shape),
        "lens": torch.zeros((slots,), dtype=torch.int32, device=dev),
        "tables": torch.full((slots, cache_len // block_size), n_blocks,
                             dtype=torch.int32, device=dev),
    }


def paged_cache_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """Axis names of the paged cache: leaves with a "blocks" axis live in
    the pool (spliced block/offset-wise); "batch" leaves are per slot."""
    kv = ("layers", "blocks", "block", "kv_heads", "head_dim")
    return {"k": kv, "v": kv, "lens": ("batch",), "tables": ("batch", None)}


def lm_prefill_paged(params: Dict[str, Any], cfg: ModelConfig, *,
                     tokens: torch.Tensor,   # (B, L) right-padded prompts
                     lens: torch.Tensor      # (B,) true lengths (<= L)
                     ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Bucket prefill for the paged engine: the slotted prefill's forward,
    with the K/V rows returned *unpadded* (``cache_len = L``) for the
    engine to scatter into pool blocks."""
    return lm_prefill_slotted(params, cfg, tokens=tokens, lens=lens,
                              cache_len=tokens.shape[1])


def lm_decode_step_paged(params: Dict[str, Any], cache: Dict[str, Any],
                         tokens: torch.Tensor,   # (B, 1)
                         active: torch.Tensor,   # (B,) bool
                         cfg: ModelConfig
                         ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step over every slot against the block pool: as
    :func:`lm_decode_step_slotted`, but K/V go through each slot's block
    table, and inactive rows never write the pool (their blocks may have
    been reassigned).  Where the step writes is the same for every layer
    and computed once; with the pools' spare blocks (a cache of
    :func:`init_paged_cache`) it has fixed shapes and reads nothing back
    to the host, so the step can be captured in a CUDA graph
    (``models/decode_graph.py``).  Layer ``i``'s pools are
    ``cache["k"][i]``, a contiguous slice, written in place."""
    check_family(cfg)
    x = embed_tokens(params, tokens, cfg)
    lens, tables = cache["lens"], cache["tables"]
    write, k_dst, v_dst = paged_write(cache, active)
    for i, lp in enumerate(params["layers"]):
        a, _, _ = attention_decode_paged(
            lp["attn"], _attn_in(lp, x, cfg), cache["k"][i], cache["v"][i],
            lens, tables, write, (k_dst[i], v_dst[i]), cfg)
        x = _mlp_residual(lp, x + a, cfg)
    x = apply_norm(cfg.norm, x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params, x, cfg)[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"], "tables": tables,
                    "lens": lens + active.to(torch.int32)}


def lm_decode_step(params: Dict[str, Any], cache: Dict[str, Any],
                   tokens: torch.Tensor, cfg: ModelConfig,
                   embeds: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step of ``tokens`` (B, 1), or of ``embeds`` (B, 1, D)
    where given, at position ``cache["len"]`` (each M-RoPE component
    there): returns (logits (B,V), updated cache); the cache's K/V are
    written in place."""
    check_family(cfg)
    x = _inputs(params, cfg, tokens, embeds)
    pos = cache["len"]
    for i, lp in enumerate(params["layers"]):
        a, _, _ = attention_decode(lp["attn"], _attn_in(lp, x, cfg),
                                   cache["k"][i], cache["v"][i], pos, cfg)
        x = _mlp_residual(lp, x + a, cfg)
    x = apply_norm(cfg.norm, x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params, x, cfg)[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"], "len": pos + 1}
