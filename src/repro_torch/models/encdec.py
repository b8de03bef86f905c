"""Whisper-style encoder-decoder (audio backbone; the conv frontend is a
stub, as in the reference).

Counterpart of ``repro/models/encdec.py``, function for function.  The
encoder takes precomputed frame embeddings (B, T, D), the conv frontend's
output, plus sinusoidal positions, and runs bidirectional self-attention.
The decoder runs causal self-attention (cached at decode), cross-attention
to the encoder's output (its K/V cached once at prefill) and a GELU MLP,
pre-LayerNorm, with sinusoidal positions and tied embeddings.

Layers are lists of per-layer dicts (``enc_layers``, ``dec_layers``)
where the reference stacks them for ``lax.scan``; caches keep its stacked
layout, (n_dec_layers, B, len, KVH, hd).  Every attention product goes
through ``models/attention.py``: where no gradient is taken the encoder's
self-attention and every cross-attention run the flash-attention op
without a mask, the decoder's prefill self-attention runs it causal, and
each decode step runs the decode-attention op for the cached
self-attention and for the cross-attention over all T_enc frames.
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
    attention_prefill,
    cross_attention_block,
    cross_attention_decode,
    cross_attention_prefill,
    attention_specs,
    init_attention,
)
from repro_torch.models.common import (
    apply_norm,
    cast_tree,
    embed_init,
    init_norm,
    norm_specs,
    remat_call,
    sinusoid,
    sinusoidal_positions,
)
from repro_torch.models.mlp import init_mlp, mlp_block, mlp_specs
from repro_torch.models.transformer import embed_tokens


# ---------------------------------------------------------------------------
# Init / cache
# ---------------------------------------------------------------------------


def _init_enc_layer(gen: torch.Generator, cfg: ModelConfig
                    ) -> Dict[str, Any]:
    return {
        "attn_norm": init_norm(cfg.norm, cfg.d_model, gen.device),
        "attn": init_attention(gen, cfg),
        "mlp_norm": init_norm(cfg.norm, cfg.d_model, gen.device),
        "mlp": init_mlp(gen, cfg),
    }


def _init_dec_layer(gen: torch.Generator, cfg: ModelConfig
                    ) -> Dict[str, Any]:
    p = _init_enc_layer(gen, cfg)
    p["cross_norm"] = init_norm(cfg.norm, cfg.d_model, gen.device)
    p["cross"] = init_attention(gen, cfg)
    return p


def init_encdec(seed: int, cfg: ModelConfig, device: DeviceLike = None
                ) -> Dict[str, Any]:
    """Random weights from a seeded ``torch.Generator`` on ``device``: the
    reference's distributions, not its numbers (parity tests copy its
    params with :func:`repro_torch.weights.params_from_jax`).  Each layer
    is cast to ``cfg.dtype`` as soon as it is drawn."""
    if cfg.family != "encdec":
        raise ValueError(f"family {cfg.family!r}: models/encdec.py serves "
                         f"the encdec family")
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model)).to(dtype),
        "enc_layers": [cast_tree(_init_enc_layer(gen, cfg), dtype)
                       for _ in range(cfg.n_layers)],
        "enc_norm": cast_tree(init_norm(cfg.norm, cfg.d_model, dev), dtype),
        "dec_layers": [cast_tree(_init_dec_layer(gen, cfg), dtype)
                       for _ in range(cfg.n_dec_layers)],
        "final_norm": cast_tree(init_norm(cfg.norm, cfg.d_model, dev),
                                dtype),
    }


def encdec_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """Logical axis names of :func:`init_encdec`'s params: ``repro``'s
    leaf for leaf, without its stacked ``layers`` prefix."""
    enc = {
        "attn_norm": norm_specs(cfg.norm),
        "attn": attention_specs(cfg),
        "mlp_norm": norm_specs(cfg.norm),
        "mlp": mlp_specs(cfg),
    }
    dec = dict(enc)
    dec["cross_norm"] = norm_specs(cfg.norm)
    dec["cross"] = attention_specs(cfg)
    return {
        "embed": ("vocab", "embed_unsharded"),
        "enc_layers": [enc] * cfg.n_layers,
        "enc_norm": norm_specs(cfg.norm),
        "dec_layers": [dec] * cfg.n_dec_layers,
        "final_norm": norm_specs(cfg.norm),
    }


def init_encdec_cache(cfg: ModelConfig, batch: int, cache_len: int,
                      enc_len: int, dtype: Optional[torch.dtype] = None,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """Zero caches: decoder self-attention ``k``/``v`` of ``cache_len``
    rows and cross ``ck``/``cv`` of ``enc_len`` rows per layer; ``len`` a
    Python int, as the LM cache's."""
    dtype = dtype or torch_dtype(cfg.dtype)
    dev = resolve_device(device)
    kvh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    self_shape = (cfg.n_dec_layers, batch, cache_len, kvh, hd)
    cross_shape = (cfg.n_dec_layers, batch, enc_len, kvh, hd)
    return {"k": torch.zeros(self_shape, dtype=dtype, device=dev),
            "v": torch.zeros(self_shape, dtype=dtype, device=dev),
            "ck": torch.zeros(cross_shape, dtype=dtype, device=dev),
            "cv": torch.zeros(cross_shape, dtype=dtype, device=dev),
            "len": 0}


def encdec_cache_specs(cfg: ModelConfig) -> Dict[str, Any]:
    kv = ("layers", "batch", None, "kv_heads", "head_dim")
    return {"k": kv, "v": kv, "ck": kv, "cv": kv, "len": ()}


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _remat(cfg: ModelConfig) -> str:
    # the reference wraps each layer in jax.checkpoint whenever remat is
    # not "none", whatever the mode
    return "none" if cfg.remat == "none" else "full"


def _enc_layer(lp: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig
               ) -> torch.Tensor:
    h = x + attention_block(
        lp["attn"], apply_norm(cfg.norm, x, lp["attn_norm"], cfg.norm_eps),
        cfg, causal=False, use_rope=False)
    h = h + mlp_block(
        lp["mlp"], apply_norm(cfg.norm, h, lp["mlp_norm"], cfg.norm_eps), cfg)
    return logical_constraint(h, "batch", "seq", None)


def encode(params: Dict[str, Any], frames: torch.Tensor, cfg: ModelConfig
           ) -> torch.Tensor:
    """frames: (B, T, D), the stub frontend's output -> the encoder's
    final-norm hidden states (B, T, D)."""
    x = frames.to(torch_dtype(cfg.dtype))
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                 x.device).to(x.dtype)
    x = logical_constraint(x, "batch", "seq", None)
    for lp in params["enc_layers"]:
        x = remat_call(_remat(cfg), _enc_layer, lp, x, cfg)
    return apply_norm(cfg.norm, x, params["enc_norm"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def _dec_inputs(params, dec_tokens: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    x = embed_tokens(params, dec_tokens, cfg)
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                 x.device).to(x.dtype)
    return logical_constraint(x, "batch", "seq", None)


def _dec_layer(lp: Dict[str, Any], x: torch.Tensor, enc_out: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    h = x + attention_block(
        lp["attn"], apply_norm(cfg.norm, x, lp["attn_norm"], cfg.norm_eps),
        cfg, causal=True, use_rope=False)
    h = h + cross_attention_block(
        lp["cross"], apply_norm(cfg.norm, h, lp["cross_norm"], cfg.norm_eps),
        enc_out, cfg)
    h = h + mlp_block(
        lp["mlp"], apply_norm(cfg.norm, h, lp["mlp_norm"], cfg.norm_eps), cfg)
    return logical_constraint(h, "batch", "seq", None)


def _decode_hidden(params, dec_tokens: torch.Tensor, enc_out: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """The teacher-forced decoder's final-norm hidden states (B, S, D)."""
    x = _dec_inputs(params, dec_tokens, cfg)
    for lp in params["dec_layers"]:
        x = remat_call(_remat(cfg), _dec_layer, lp, x, enc_out, cfg)
    return apply_norm(cfg.norm, x, params["final_norm"], cfg.norm_eps)


def decode_train(params, dec_tokens: torch.Tensor, enc_out: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Teacher-forced decoder forward. Returns logits (B, S_dec, V)."""
    return encdec_unembed(params, _decode_hidden(params, dec_tokens,
                                                 enc_out, cfg), cfg)


def encdec_unembed(params, x: torch.Tensor, cfg: ModelConfig
                   ) -> torch.Tensor:
    logits = x @ params["embed"].T.to(x.dtype)      # tied
    return logical_constraint(logits, "batch", "seq", "vocab")


def encdec_hidden(params, cfg: ModelConfig, *, frames: torch.Tensor,
                  dec_tokens: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decoder final hidden states (pre-unembed) for the chunked loss, and
    a zero auxiliary loss."""
    x = _decode_hidden(params, dec_tokens, encode(params, frames, cfg), cfg)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def encdec_forward(params, cfg: ModelConfig, *, frames: torch.Tensor,
                   dec_tokens: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits (B, S_dec, V), a zero auxiliary loss)."""
    logits = decode_train(params, dec_tokens, encode(params, frames, cfg),
                          cfg)
    return logits, torch.zeros((), dtype=torch.float32,
                               device=logits.device)


# ---------------------------------------------------------------------------
# Prefill / decode (serving)
# ---------------------------------------------------------------------------


def encdec_prefill(params, cfg: ModelConfig, *, frames: torch.Tensor,
                   dec_tokens: torch.Tensor, cache_len: int):
    """Encode the audio, teacher-force the decoder prompt, and build the
    caches: self-attention K/V padded to ``cache_len``, cross K/V computed
    once from the encoder's output.  Returns (last-token logits (B, V),
    cache)."""
    enc_out = encode(params, frames, cfg)
    x = _dec_inputs(params, dec_tokens, cfg)
    s = dec_tokens.shape[1]
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    cks: List[torch.Tensor] = []
    cvs: List[torch.Tensor] = []
    for lp in params["dec_layers"]:
        a, (kc, vc) = attention_prefill(
            lp["attn"], apply_norm(cfg.norm, x, lp["attn_norm"],
                                   cfg.norm_eps),
            cfg, cache_len, use_rope=False)
        h = x + a
        c, (ck, cv) = cross_attention_prefill(
            lp["cross"], apply_norm(cfg.norm, h, lp["cross_norm"],
                                    cfg.norm_eps), enc_out, cfg)
        h = h + c
        x = h + mlp_block(
            lp["mlp"], apply_norm(cfg.norm, h, lp["mlp_norm"], cfg.norm_eps),
            cfg)
        ks.append(kc)
        vs.append(vc)
        cks.append(ck)
        cvs.append(cv)
    x = apply_norm(cfg.norm, x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = encdec_unembed(params, x, cfg)[:, 0]
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs),
                    "ck": torch.stack(cks), "cv": torch.stack(cvs),
                    "len": s}


def encdec_decode_step(params, cache: Dict[str, Any], tokens: torch.Tensor,
                       cfg: ModelConfig
                       ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decoder token (B, 1) at position ``cache["len"]``: returns
    (logits (B, V), cache).  The self-attention caches are written in
    place; the cross caches are static."""
    x = embed_tokens(params, tokens, cfg)
    pos = cache["len"]
    # row ``pos`` of the sinusoid, computed alone, as the reference's step
    x = x + sinusoid(torch.tensor(float(pos), device=x.device),
                     cfg.d_model).to(x.dtype)
    for i, lp in enumerate(params["dec_layers"]):
        a, _, _ = attention_decode(
            lp["attn"], apply_norm(cfg.norm, x, lp["attn_norm"],
                                   cfg.norm_eps),
            cache["k"][i], cache["v"][i], pos, cfg, use_rope=False)
        h = x + a
        h = h + cross_attention_decode(
            lp["cross"], apply_norm(cfg.norm, h, lp["cross_norm"],
                                    cfg.norm_eps),
            cache["ck"][i], cache["cv"][i], cfg)
        x = h + mlp_block(
            lp["mlp"], apply_norm(cfg.norm, h, lp["mlp_norm"], cfg.norm_eps),
            cfg)
    x = apply_norm(cfg.norm, x, params["final_norm"], cfg.norm_eps)
    logits = encdec_unembed(params, x, cfg)[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"], "ck": cache["ck"],
                    "cv": cache["cv"], "len": pos + 1}
