"""Decoder-only LM, dense and MoE families.

Counterpart of ``repro/models/transformer.py``.  The reference stacks layer
parameters on a leading ``layers`` axis for ``lax.scan``; PyTorch runs
eagerly, so here ``params["layers"]`` is a list of per-layer dicts and the
scan is a Python loop.  KV caches keep the reference's stacked layout,
``(layers, batch, cache_len, kv_heads, head_dim)``, and decode writes each
layer's slice of it in place.  The reference's ``logical_constraint``
sharding hints do nothing on one device and are dropped.

Entry points: ``lm_forward`` (training), ``lm_prefill`` / ``lm_decode_step``
(one shared length), their ``_slotted`` forms (per-slot lengths, the
serving engine's dense path) and their ``_paged`` forms (a block pool
shared by every slot, the paged engine's path).  An MoE layer holds
``moe`` where a dense one holds ``mlp``; training sums the layers' load-
balance losses, serving discards them, as the reference does.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.models.attention import (
    attention_block,
    attention_decode,
    attention_decode_paged,
    attention_decode_slotted,
    attention_prefill,
    init_attention,
    paged_write_index,
)
from repro_torch.models.common import (
    apply_norm,
    cast_tree,
    embed_init,
    init_norm,
)
from repro_torch.models.mlp import init_mlp, mlp_block
from repro_torch.models.moe import init_moe, moe_block


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not yet ported (this module serves "
            f"the dense and MoE LM families; ssm and hybrid are "
            f"models/hybrid.py)")


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


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    x = params["embed"].index_select(0, tokens.reshape(-1))
    return x.reshape(*tokens.shape, -1).to(torch_dtype(cfg.dtype))


def unembed(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"].T.to(x.dtype)
    return x @ params["unembed"].to(x.dtype)


def lm_hidden(params: Dict[str, Any], cfg: ModelConfig, *,
              tokens: torch.Tensor,
              positions: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backbone forward. Returns (final-norm hidden (B,S,D), aux_loss): the
    sum of the MoE layers' load-balance losses, a zero for the dense
    family."""
    check_family(cfg)
    x = embed_tokens(params, tokens, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params["layers"]:
        h = x + attention_block(lp["attn"], _attn_in(lp, x, cfg), cfg,
                                positions=positions, causal=True)
        x, aux_l = _ffn_residual(lp, h, cfg)
        if aux_l is not None:
            aux = aux + aux_l
    x = apply_norm(cfg.norm, x, params["final_norm"], cfg.norm_eps)
    return x, aux


def lm_forward(params: Dict[str, Any], cfg: ModelConfig, *,
               tokens: torch.Tensor,
               positions: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward. Returns (logits (B,S,V), aux_loss)."""
    x, aux = lm_hidden(params, cfg, tokens=tokens, positions=positions)
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
    for lp in params["layers"]:
        a, (kc, vc) = attention_prefill(lp["attn"], _attn_in(lp, x, cfg),
                                        cfg, cache_len, positions=positions)
        x = _mlp_residual(lp, x + a, cfg)
        ks.append(kc)
        vs.append(vc)
    return x, torch.stack(ks), torch.stack(vs)


def lm_prefill(params: Dict[str, Any], cfg: ModelConfig, *,
               tokens: torch.Tensor,
               positions: Optional[torch.Tensor] = None,
               cache_len: int) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Prefill pass: returns (last-token logits (B,V), populated cache)."""
    check_family(cfg)
    x = embed_tokens(params, tokens, cfg)
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
    last-real-token logits ``(B, V)`` and a slot cache.
    """
    check_family(cfg)
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
    unwritten positions hold finite values, and written in place by decode;
    ``tables``: (slots, cache_len // block_size) int32, the sentinel
    ``n_blocks`` marking unallocated entries; ``lens``: per-slot lengths."""
    if cache_len % block_size:
        raise ValueError(f"cache_len {cache_len} is not a multiple of "
                         f"block_size {block_size}")
    dtype = dtype or torch_dtype(cfg.dtype)
    dev = resolve_device(device)
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
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
    and computed once.  Layer ``i``'s pools are ``cache["k"][i]``, a
    contiguous slice, written in place."""
    check_family(cfg)
    x = embed_tokens(params, tokens, cfg)
    lens, tables = cache["lens"], cache["tables"]
    write = paged_write_index(lens, tables, active, cache["k"].shape[2],
                              cache["k"].shape[1])
    for i, lp in enumerate(params["layers"]):
        a, _, _ = attention_decode_paged(
            lp["attn"], _attn_in(lp, x, cfg), cache["k"][i], cache["v"][i],
            lens, tables, write, cfg)
        x = _mlp_residual(lp, x + a, cfg)
    x = apply_norm(cfg.norm, x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params, x, cfg)[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"], "tables": tables,
                    "lens": lens + active.to(torch.int32)}


def lm_decode_step(params: Dict[str, Any], cache: Dict[str, Any],
                   tokens: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step: returns (logits (B,V), updated cache); the cache's
    K/V are written in place."""
    check_family(cfg)
    x = embed_tokens(params, tokens, cfg)
    pos = cache["len"]
    for i, lp in enumerate(params["layers"]):
        a, _, _ = attention_decode(lp["attn"], _attn_in(lp, x, cfg),
                                   cache["k"][i], cache["v"][i], pos, cfg)
        x = _mlp_residual(lp, x + a, cfg)
    x = apply_norm(cfg.norm, x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params, x, cfg)[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"], "len": pos + 1}
