"""Zamba2-style hybrid backbone: Mamba-2 layers + a SHARED attention block.

Counterpart of ``repro/models/hybrid.py``.  ``n_layers`` Mamba-2 blocks;
after every ``attn_period`` of them one *shared* transformer block
(attention + MLP, one parameter set reused at every application) is
applied.  A pure-SSM config (``attn_period=0``, mamba2-780m) has no groups
and no shared block: every layer is a tail layer.  Simplifications of the
reference, kept: no per-application LoRA deltas on the shared block, and
the shared block consumes the current hidden state rather than
concat(hidden, embedding).

Layout: the reference stacks the group layers ``(n_groups, period, ...)``
and the tail ``(tail, ...)`` for ``lax.scan``; PyTorch runs eagerly, so
here ``params["groups"]`` is a list of ``n_groups`` lists of per-layer
dicts, ``params["tail"]`` a list, and ``params["shared"]`` is stored once.
Caches keep the reference's stacked layout: conv states ``(n_groups,
period, B, K-1, C)`` and ``(tail, B, K-1, C)``, SSM states ``(..., B, H, N,
P)`` f32, and one K/V cache (or block pool) per shared-block application,
``(n_groups, B, S, KVH, hd)`` (or ``(n_groups, P, BS, KVH, hd)``).  Decode
writes every state and K/V row in place and returns the caches.

Prefill runs each Mamba layer's scan through ``kernels/ssd`` and each
shared-block application's causal attention through
``kernels/flash_attention``; decode runs the SSM step in plain PyTorch and
the shared block's attention through ``kernels/decode_attention`` (dense
or paged).  Prefill takes exact-length prompts only: SSM states fold every
input token, so right-padding would corrupt them (``prefill_pads=False``
in the registry; the engine uses ``pad_to=1``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.distributed.sharding import logical_constraint
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
from repro_torch.models.mamba2 import (
    init_mamba2,
    mamba2_block,
    mamba2_decode,
    mamba2_mix,
    mamba2_specs,
)
from repro_torch.models.mlp import init_mlp, mlp_specs
from repro_torch.models.transformer import attn_mlp_block, embed_tokens


def _layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_groups, group_size, n_tail): groups end with a shared-block
    application."""
    period = cfg.attn_period or cfg.n_layers + 1
    n_groups = cfg.n_layers // period
    return n_groups, period, cfg.n_layers - n_groups * period


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_hybrid(seed: int, cfg: ModelConfig, device: DeviceLike = None
                ) -> Dict[str, Any]:
    """Random weights from a seeded ``torch.Generator`` on ``device``, with
    the reference's distributions and shapes (not its numbers: parity
    tests copy the reference's params with ``params_from_jax``).  Each
    layer is cast to ``cfg.dtype`` as soon as it is drawn."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n_groups, period, tail = _layout(cfg)

    def layer():
        return cast_tree({"norm": init_norm(cfg.norm, cfg.d_model, dev),
                          "mamba": init_mamba2(gen, cfg)}, dtype)

    params: Dict[str, Any] = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model)).to(dtype),
        "final_norm": cast_tree(init_norm(cfg.norm, cfg.d_model, dev), dtype),
        "unembed": embed_init(gen, (cfg.d_model, cfg.vocab_size)).to(dtype),
    }
    if n_groups:
        params["groups"] = [[layer() for _ in range(period)]
                            for _ in range(n_groups)]
        params["shared"] = cast_tree({
            "attn_norm": init_norm(cfg.norm, cfg.d_model, dev),
            "attn": init_attention(gen, cfg),
            "mlp_norm": init_norm(cfg.norm, cfg.d_model, dev),
            "mlp": init_mlp(gen, cfg),
        }, dtype)
    if tail:
        params["tail"] = [layer() for _ in range(tail)]
    return params


def hybrid_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """Logical axis names of :func:`init_hybrid`'s params: ``repro``'s
    leaf for leaf, without its stacked ``layer_groups``/``layers``
    prefixes (``groups`` is a list of lists here, ``tail`` a list)."""
    n_groups, period, tail = _layout(cfg)
    lp = {"norm": norm_specs(cfg.norm), "mamba": mamba2_specs(cfg)}
    specs: Dict[str, Any] = {
        "embed": ("vocab", "embed_unsharded"),
        "final_norm": norm_specs(cfg.norm),
        "unembed": ("embed_unsharded", "vocab"),
    }
    if n_groups:
        specs["groups"] = [[lp] * period for _ in range(n_groups)]
        specs["shared"] = {
            "attn_norm": norm_specs(cfg.norm),
            "attn": attention_specs(cfg),
            "mlp_norm": norm_specs(cfg.norm),
            "mlp": mlp_specs(cfg),
        }
    if tail:
        specs["tail"] = [lp] * tail
    return specs


# ---------------------------------------------------------------------------
# Forward (training)
# ---------------------------------------------------------------------------


def _norm(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return apply_norm(cfg.norm, x, p, cfg.norm_eps)


def _mamba_layer_fwd(lp, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    out = x + mamba2_block(lp["mamba"], _norm(lp["norm"], x, cfg), cfg)
    return logical_constraint(out, "batch", "seq", None)


def _group_fwd(group, shared, x: torch.Tensor, cfg: ModelConfig,
               positions: Optional[torch.Tensor]) -> torch.Tensor:
    for lp in group:
        x = _mamba_layer_fwd(lp, x, cfg)
    x = attn_mlp_block(shared, x, lambda xn: attention_block(
        shared["attn"], xn, cfg, positions=positions, causal=True), cfg)
    return logical_constraint(x, "batch", "seq", None)


def hybrid_hidden(params: Dict[str, Any], cfg: ModelConfig, *,
                  tokens: torch.Tensor,
                  positions: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backbone forward. Returns (final-norm hidden (B,S,D), aux_loss = 0).
    Where a gradient is taken, each group (its Mamba layers and the shared
    block) and each tail layer is rematerialised unless ``cfg.remat`` is
    ``"none"``, as the reference checkpoints its two scan bodies (its
    ``"dots"`` is ``"full"`` here)."""
    mode = "none" if cfg.remat == "none" else "full"
    x = logical_constraint(embed_tokens(params, tokens, cfg),
                           "batch", "seq", None)
    shared = params.get("shared")
    for group in params.get("groups", []):
        x = remat_call(mode, _group_fwd, group, shared, x, cfg, positions)
    for lp in params.get("tail", []):
        x = remat_call(mode, _mamba_layer_fwd, lp, x, cfg)
    x = _norm(params["final_norm"], x, cfg)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def hybrid_unembed(params, x: torch.Tensor, cfg: ModelConfig
                   ) -> torch.Tensor:
    logits = x @ params["unembed"].to(x.dtype)
    return logical_constraint(logits, "batch", "seq", "vocab")


def hybrid_forward(params: Dict[str, Any], cfg: ModelConfig, *,
                   tokens: torch.Tensor,
                   positions: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward. Returns (logits (B,S,V), aux_loss)."""
    x, aux = hybrid_hidden(params, cfg, tokens=tokens, positions=positions)
    return hybrid_unembed(params, x, cfg), aux


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def _state_leaves(cfg: ModelConfig, batch: int, device: torch.device
                  ) -> Dict[str, torch.Tensor]:
    """Zero conv and SSM states: per row, O(1) in the sequence length."""
    n_groups, period, tail = _layout(cfg)
    dt = torch_dtype(cfg.dtype)
    conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    conv = (batch, cfg.conv_kernel - 1, conv_ch)
    ssm = (batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)
    leaves = {
        "conv_tail": torch.zeros((tail,) + conv, dtype=dt, device=device),
        "ssm_tail": torch.zeros((tail,) + ssm, dtype=torch.float32,
                                device=device),
    }
    if n_groups:
        leaves["conv"] = torch.zeros((n_groups, period) + conv, dtype=dt,
                                     device=device)
        leaves["ssm"] = torch.zeros((n_groups, period) + ssm,
                                    dtype=torch.float32, device=device)
    return leaves


def init_hybrid_cache(cfg: ModelConfig, batch: int, cache_len: int,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """Zero cache of one shared length (``len`` is a Python int, as in the
    dense family's cache)."""
    dev = resolve_device(device)
    n_groups, _, _ = _layout(cfg)
    cache: Dict[str, Any] = dict(_state_leaves(cfg, batch, dev), len=0)
    if n_groups:
        kv = (n_groups, batch, cache_len, cfg.n_kv_heads,
              cfg.resolved_head_dim)
        dt = torch_dtype(cfg.dtype)
        cache["k"] = torch.zeros(kv, dtype=dt, device=dev)
        cache["v"] = torch.zeros(kv, dtype=dt, device=dev)
    return cache


def hybrid_cache_specs(cfg: ModelConfig) -> Dict[str, Any]:
    n_groups, _, _ = _layout(cfg)
    specs: Dict[str, Any] = {
        "conv_tail": ("layers", "batch", None, "heads"),
        "ssm_tail": ("layers", "batch", "heads", None, None),
        "len": (),
    }
    if n_groups:
        specs.update({
            "conv": ("layer_groups", "layers", "batch", None, "heads"),
            "ssm": ("layer_groups", "layers", "batch", "heads", None, None),
            "k": ("layer_groups", "batch", None, "kv_heads", "head_dim"),
            "v": ("layer_groups", "batch", None, "kv_heads", "head_dim"),
        })
    return specs


def init_hybrid_slot_cache(cfg: ModelConfig, batch: int, cache_len: int,
                           device: DeviceLike = None) -> Dict[str, Any]:
    """Slot-cache layout: per-slot ``lens`` instead of the shared ``len``.
    Conv/SSM states are already per row; only the shared block's KV cache
    and the RoPE position need the per-slot length."""
    cache = init_hybrid_cache(cfg, batch, cache_len, device)
    del cache["len"]
    cache["lens"] = torch.zeros((batch,), dtype=torch.int32,
                                device=cache["conv_tail"].device)
    return cache


def init_hybrid_paged_cache(cfg: ModelConfig, slots: int, cache_len: int,
                            n_blocks: int, block_size: int,
                            device: DeviceLike = None) -> Dict[str, Any]:
    """Paged hybrid cache: only the shared block's K/V live in a block pool
    (one per application); conv/SSM states stay dense per row.  ``tables``
    (slots, cache_len // block_size) int32 holds the sentinel ``n_blocks``
    where nothing is allocated."""
    if cache_len % block_size:
        raise ValueError(f"cache_len {cache_len} is not a multiple of "
                         f"block_size {block_size}")
    dev = resolve_device(device)
    n_groups, _, _ = _layout(cfg)
    cache: Dict[str, Any] = dict(
        _state_leaves(cfg, slots, dev),
        lens=torch.zeros((slots,), dtype=torch.int32, device=dev),
        tables=torch.full((slots, cache_len // block_size), n_blocks,
                          dtype=torch.int32, device=dev))
    if n_groups:
        kv = (n_groups, n_blocks, block_size, cfg.n_kv_heads,
              cfg.resolved_head_dim, slots, torch_dtype(cfg.dtype), dev)
        cache["k"] = paged_pool(*kv)
        cache["v"] = paged_pool(*kv)
    return cache


def hybrid_paged_cache_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """Leaves with a "blocks" axis live in the pool (spliced block/offset-
    wise); the other "batch" leaves are per slot (spliced at that axis)."""
    n_groups, _, _ = _layout(cfg)
    specs: Dict[str, Any] = {
        "conv_tail": ("layers", "batch", None, "heads"),
        "ssm_tail": ("layers", "batch", "heads", None, None),
        "lens": ("batch",),
        "tables": ("batch", None),
    }
    if n_groups:
        kv = ("layer_groups", "blocks", "block", "kv_heads", "head_dim")
        specs.update({
            "conv": ("layer_groups", "layers", "batch", None, "heads"),
            "ssm": ("layer_groups", "layers", "batch", "heads", None, None),
            "k": kv,
            "v": kv,
        })
    return specs


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def hybrid_prefill(params: Dict[str, Any], cfg: ModelConfig, *,
                   tokens: torch.Tensor, cache_len: int
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the full-sequence forward while building every cache: each
    Mamba layer keeps its last K-1 conv inputs and its scan's final state;
    each shared-block application keeps its K/V, padded to ``cache_len``.
    Returns (last-token logits (B, V), cache)."""
    x = embed_tokens(params, tokens, cfg)
    b, s = tokens.shape
    n_groups, period, tail = _layout(cfg)

    def mamba(lp, x_):
        out, conv, ssm = mamba2_mix(lp["mamba"], _norm(lp["norm"], x_, cfg),
                                    cfg)
        return x_ + out, conv, ssm

    cache: Dict[str, Any] = {"len": s}
    if n_groups:
        shared = params["shared"]
        convs, ssms, ks, vs = [], [], [], []

        def attend(xn):
            a, (kc, vc) = attention_prefill(shared["attn"], xn, cfg,
                                            cache_len)
            ks.append(kc)
            vs.append(vc)
            return a
        for group in params["groups"]:
            gc: List[torch.Tensor] = []
            gs: List[torch.Tensor] = []
            for lp in group:
                x, conv, ssm = mamba(lp, x)
                gc.append(conv)
                gs.append(ssm)
            x = attn_mlp_block(shared, x, attend, cfg)
            convs.append(torch.stack(gc))
            ssms.append(torch.stack(gs))
        cache.update(conv=torch.stack(convs), ssm=torch.stack(ssms),
                     k=torch.stack(ks), v=torch.stack(vs))
    if tail:
        tc, ts = [], []
        for lp in params["tail"]:
            x, conv, ssm = mamba(lp, x)
            tc.append(conv)
            ts.append(ssm)
        cache.update(conv_tail=torch.stack(tc), ssm_tail=torch.stack(ts))
    else:   # no tail layer: empty stacks, as the reference keeps
        leaves = _state_leaves(cfg, b, x.device)
        cache.update(conv_tail=leaves["conv_tail"],
                     ssm_tail=leaves["ssm_tail"])
    x = _norm(params["final_norm"], x[:, -1:], cfg)
    logits = (x @ params["unembed"].to(x.dtype))[:, 0]
    return logits, cache


def hybrid_prefill_slotted(params: Dict[str, Any], cfg: ModelConfig, *,
                           tokens: torch.Tensor, lens: torch.Tensor,
                           cache_len: int
                           ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Exact-length bucket prefill: ``lens`` must equal the batch's shared
    sequence length (SSM states fold every input token, so right-padding
    would corrupt them).  Returns per-row logits and a slot cache."""
    logits, cache = hybrid_prefill(params, cfg, tokens=tokens,
                                   cache_len=cache_len)
    del cache["len"]
    cache["lens"] = torch.full((tokens.shape[0],), tokens.shape[1],
                               dtype=torch.int32, device=tokens.device)
    return logits, cache


def hybrid_prefill_paged(params: Dict[str, Any], cfg: ModelConfig, *,
                         tokens: torch.Tensor, lens: torch.Tensor
                         ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Exact-length bucket prefill for the paged engine: K/V rows come back
    unpadded (cache_len = L) for the engine to scatter into pool blocks."""
    return hybrid_prefill_slotted(params, cfg, tokens=tokens, lens=lens,
                                  cache_len=tokens.shape[1])


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _decode_layers(params: Dict[str, Any], cache: Dict[str, Any],
                   tokens: torch.Tensor, cfg: ModelConfig, attend
                   ) -> torch.Tensor:
    """One token through every layer; conv/SSM states are written in
    place.  ``attend(attn_params, h, group)`` is the shared block's
    attention at application ``group`` (it writes that application's K/V).
    Returns the logits (B, V)."""
    x = embed_tokens(params, tokens, cfg)

    def mamba(lp, x_, conv, ssm):
        y, conv_new, ssm_new = mamba2_decode(
            lp["mamba"], _norm(lp["norm"], x_, cfg), conv, ssm, cfg)
        conv.copy_(conv_new)
        ssm.copy_(ssm_new)
        return x_ + y

    shared = params.get("shared")
    for gi, group in enumerate(params.get("groups", [])):
        for li, lp in enumerate(group):
            x = mamba(lp, x, cache["conv"][gi, li], cache["ssm"][gi, li])
        x = attn_mlp_block(shared, x,
                           lambda xn: attend(shared["attn"], xn, gi), cfg)
    for ti, lp in enumerate(params.get("tail", [])):
        x = mamba(lp, x, cache["conv_tail"][ti], cache["ssm_tail"][ti])
    x = _norm(params["final_norm"], x, cfg)
    return (x @ params["unembed"].to(x.dtype))[:, 0]


def hybrid_decode_step(params: Dict[str, Any], cache: Dict[str, Any],
                       tokens: torch.Tensor, cfg: ModelConfig
                       ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode token at one shared position (the engine's oracle)."""
    pos = cache["len"]

    def attend(ap, h, gi):
        return attention_decode(ap, h, cache["k"][gi], cache["v"][gi], pos,
                                cfg)[0]
    logits = _decode_layers(params, cache, tokens, cfg, attend)
    return logits, dict(cache, len=pos + 1)


def hybrid_decode_step_slotted(params: Dict[str, Any], cache: Dict[str, Any],
                               tokens: torch.Tensor, active: torch.Tensor,
                               cfg: ModelConfig
                               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode token per slot with independent per-slot lengths.  Mamba
    state updates are row-local, so inactive slots churn dead state that
    the next prefill replaces wholesale; the shared attention block writes
    and masks at each slot's own position."""
    lens = cache["lens"]

    def attend(ap, h, gi):
        return attention_decode_slotted(ap, h, cache["k"][gi],
                                        cache["v"][gi], lens, cfg)[0]
    logits = _decode_layers(params, cache, tokens, cfg, attend)
    return logits, dict(cache, lens=lens + active.to(torch.int32))


def hybrid_decode_step_paged(params: Dict[str, Any], cache: Dict[str, Any],
                             tokens: torch.Tensor, active: torch.Tensor,
                             cfg: ModelConfig
                             ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode token per slot against the shared block's K/V pools:
    conv/SSM states update densely per row as in the slotted step; the
    shared block writes and reads through each slot's block table, and
    inactive rows never write a pool (where the step writes is computed
    once, for every application)."""
    lens, tables = cache["lens"], cache["tables"]
    write = k_dst = v_dst = kv_lens = None
    if "k" in cache:
        write, k_dst, v_dst = paged_write(cache, active)
        kv_lens = lens + 1

    def attend(ap, h, gi):
        return attention_decode_paged(ap, h, cache["k"][gi], cache["v"][gi],
                                      kv_lens, tables, write,
                                      (k_dst[gi], v_dst[gi]), cfg)[0]
    logits = _decode_layers(params, cache, tokens, cfg, attend)
    return logits, dict(cache, lens=lens + active.to(torch.int32))
