"""ModelBundle: one functional API over the ported architecture families.

Counterpart of ``repro/models/registry.py``.  Family dispatch happens
once, here: the dense, MoE and VLM LM families, the SSM and hybrid
families (mamba2, zamba2), and the encoder-decoder (whisper).  A VLM batch
carries ``embeds`` (B, S, D) and ``positions`` (3, B, S) where an LM batch
carries ``tokens``; an encoder-decoder batch carries ``frames`` (B, T, D)
and ``dec_tokens`` (B, S_dec), and its bundle has no slotted or paged
serving path, as the reference's has none.

* ``init(seed, device) -> params`` (shapes only, no draw, under
  ``FakeTensorMode``)
* ``specs() -> tree of logical axes`` beside the params (``repro``'s
  leaves without the stacked layer prefixes)
* ``input_specs(cell) -> (tree of meta tensors, tree of logical axes)``
  and ``cache_shapes(cell) -> tree of meta tensors`` (the dry run's I/O;
  nothing is allocated); ``supports(cell)`` the assignment's skip rule
* ``apply_train(params, batch) -> (logits, aux)`` — full teacher-forced pass
* ``apply_hidden(params, batch) -> (hidden, aux)`` and
  ``unembed_chunk(params, x) -> logits`` — the chunked loss's halves
* ``prefill(params, batch) -> (last_logits, cache)``
* ``decode_step(params, cache, batch) -> (logits, cache)``
* ``make_cache(batch, cache_len, device)`` / ``make_slot_cache(...)``
* ``prefill_slotted`` / ``decode_slotted`` — per-slot lengths (serving)
* ``prefill_paged`` / ``decode_paged`` / ``make_paged_cache(slots,
  cache_len, n_blocks, block_size, device)`` / ``paged_cache_specs`` — the
  paged KV cache (a block pool shared by every slot); the LM families'
  ``decode_paged`` replays its step as a CUDA graph on one card
  (``models/decode_graph.py``), and its ``eager`` is the step itself;
  each paged call records a ``model.glue`` span (``models/glue.py``)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ENCDEC_DECODE_ENC_LEN, ShapeCell
from repro_torch.device import torch_dtype
from repro_torch.models import encdec as M_encdec
from repro_torch.models import glue
from repro_torch.models import hybrid as M_hybrid
from repro_torch.models import transformer as M_lm
from repro_torch.models.decode_graph import DecodeGraphs


@dataclasses.dataclass
class ModelBundle:
    cfg: ModelConfig
    init: Callable[..., Any]
    specs: Callable[[], Any]
    apply_train: Callable[[Any, Dict[str, Any]],
                          Tuple[torch.Tensor, torch.Tensor]]
    prefill: Callable[[Any, Dict[str, Any]], Tuple[torch.Tensor, Any]]
    decode_step: Callable[[Any, Any, Dict[str, Any]],
                          Tuple[torch.Tensor, Any]]
    make_cache: Callable[..., Any]
    cache_specs: Callable[[], Any]
    # chunked-loss path: backbone hidden states + per-chunk unembed, so
    # (B, S, V) logits never fully materialise in training
    apply_hidden: Optional[Callable[[Any, Dict[str, Any]],
                                    Tuple[torch.Tensor, torch.Tensor]]] = None
    unembed_chunk: Optional[Callable[[Any, torch.Tensor],
                                     torch.Tensor]] = None
    # slot-cache serving path: ``prefill_slotted(params, {"tokens": (B, L),
    # "lens": (B,), "cache_len": int})``, ``decode_slotted(params, cache,
    # {"tokens": (B, 1), "active": (B,) bool})``; ``prefill_pads`` says
    # whether prefill_slotted accepts right-padded prompts.
    prefill_slotted: Optional[Callable[[Any, Dict[str, Any]],
                                       Tuple[torch.Tensor, Any]]] = None
    decode_slotted: Optional[Callable[[Any, Any, Dict[str, Any]],
                                      Tuple[torch.Tensor, Any]]] = None
    make_slot_cache: Optional[Callable[..., Any]] = None
    prefill_pads: bool = False
    # paged serving path: ``prefill_paged(params, {"tokens", "lens"})``
    # returns unpadded K/V rows; ``decode_paged(params, cache, {"tokens",
    # "active"})`` reads and writes the block pool through cache["tables"]
    prefill_paged: Optional[Callable] = None
    decode_paged: Optional[Callable] = None
    make_paged_cache: Optional[Callable] = None
    paged_cache_specs: Optional[Callable] = None

    # ------------------------------------------------------------ dry-run io
    def input_specs(self, cell: ShapeCell) -> Tuple[Dict[str, Any],
                                                    Dict[str, Any]]:
        """The batch of ``cell`` as meta tensors (``repro``'s shapes and
        dtypes: int32 ids, ``cfg.dtype`` embeddings) and each leaf's
        logical axes."""
        cfg = self.cfg
        b, s = cell.global_batch, cell.seq_len
        dt = torch_dtype(cfg.dtype)

        def tok(shape):
            return torch.empty(shape, dtype=torch.int32, device="meta")

        def emb(shape):
            return torch.empty(shape, dtype=dt, device="meta")

        if cell.kind == "decode":
            return {"tokens": tok((b, 1))}, {"tokens": ("batch", None)}

        if cfg.family == "vlm":
            specs = {"embeds": emb((b, s, cfg.d_model)),
                     "positions": tok((3, b, s))}
            axes = {"embeds": ("batch", "seq", None),
                    "positions": (None, "batch", "seq")}
        elif cfg.family == "encdec":
            sd = max(s // cfg.dec_ratio, 8)
            specs = {"frames": emb((b, s, cfg.d_model)),
                     "dec_tokens": tok((b, sd))}
            axes = {"frames": ("batch", "seq", None),
                    "dec_tokens": ("batch", "seq")}
        else:
            specs = {"tokens": tok((b, s))}
            axes = {"tokens": ("batch", "seq")}

        if cell.kind == "train":
            if cfg.family == "encdec":
                specs["labels"] = tok((b, max(s // cfg.dec_ratio, 8)))
            else:
                specs["labels"] = tok((b, s))
            axes["labels"] = ("batch", "seq")
        return specs, axes

    def cache_shapes(self, cell: ShapeCell) -> Any:
        """The decode cache of ``cell`` on the meta device (no
        allocation)."""
        return self.make_cache(cell.global_batch, cell.seq_len,
                               device="meta")

    def supports(self, cell: ShapeCell) -> Tuple[bool, str]:
        """Assignment skip rules (DESIGN.md §4)."""
        if cell.name == "long_500k" and not self.cfg.sub_quadratic:
            return False, ("full-attention arch: 500k-token KV decode is the "
                           "quadratic regime the assignment excludes")
        return True, ""


def _lm_bundle(cfg: ModelConfig) -> ModelBundle:
    def apply_train(params, batch):
        return M_lm.lm_forward(params, cfg, tokens=batch.get("tokens"),
                               embeds=batch.get("embeds"),
                               positions=batch.get("positions"))

    def apply_hidden(params, batch):
        return M_lm.lm_hidden(params, cfg, tokens=batch.get("tokens"),
                              embeds=batch.get("embeds"),
                              positions=batch.get("positions"))

    def prefill(params, batch):
        return M_lm.lm_prefill(params, cfg, tokens=batch.get("tokens"),
                               embeds=batch.get("embeds"),
                               positions=batch.get("positions"),
                               cache_len=batch["cache_len"])

    def decode_step(params, cache, batch):
        return M_lm.lm_decode_step(params, cache, batch["tokens"], cfg)

    def prefill_slotted(params, batch):
        return M_lm.lm_prefill_slotted(params, cfg, tokens=batch["tokens"],
                                       lens=batch["lens"],
                                       cache_len=batch["cache_len"])

    def decode_slotted(params, cache, batch):
        return M_lm.lm_decode_step_slotted(params, cache, batch["tokens"],
                                           batch["active"], cfg)

    def prefill_paged(params, batch):
        return M_lm.lm_prefill_paged(params, cfg, tokens=batch["tokens"],
                                     lens=batch["lens"])

    def decode_paged(params, cache, batch):
        return M_lm.lm_decode_step_paged(params, cache, batch["tokens"],
                                         batch["active"], cfg)

    def make_paged_cache(slots, cache_len, n_blocks, block_size,
                         device=None):
        return M_lm.init_paged_cache(cfg, slots, cache_len, n_blocks,
                                     block_size, device=device)

    return ModelBundle(
        cfg=cfg,
        init=lambda seed=0, device=None: M_lm.init_lm(seed, cfg, device),
        specs=lambda: M_lm.lm_specs(cfg),
        apply_train=apply_train,
        prefill=prefill,
        decode_step=decode_step,
        make_cache=lambda b, s, device=None: M_lm.init_cache(
            cfg, b, s, device=device),
        cache_specs=lambda: M_lm.cache_specs(cfg),
        apply_hidden=apply_hidden,
        unembed_chunk=lambda params, x: M_lm.unembed(params, x, cfg),
        prefill_slotted=prefill_slotted,
        decode_slotted=decode_slotted,
        make_slot_cache=lambda b, s, device=None: M_lm.init_slot_cache(
            cfg, b, s, device=device),
        prefill_pads=True,
        prefill_paged=glue.recorded(prefill_paged),
        decode_paged=DecodeGraphs(decode_paged),
        make_paged_cache=make_paged_cache,
        paged_cache_specs=lambda: M_lm.paged_cache_specs(cfg),
    )


def _hybrid_bundle(cfg: ModelConfig) -> ModelBundle:
    def apply_train(params, batch):
        return M_hybrid.hybrid_forward(params, cfg, tokens=batch["tokens"])

    def prefill(params, batch):
        return M_hybrid.hybrid_prefill(params, cfg, tokens=batch["tokens"],
                                       cache_len=batch["cache_len"])

    def decode_step(params, cache, batch):
        return M_hybrid.hybrid_decode_step(params, cache, batch["tokens"],
                                           cfg)

    def prefill_slotted(params, batch):
        return M_hybrid.hybrid_prefill_slotted(
            params, cfg, tokens=batch["tokens"], lens=batch["lens"],
            cache_len=batch["cache_len"])

    def decode_slotted(params, cache, batch):
        return M_hybrid.hybrid_decode_step_slotted(
            params, cache, batch["tokens"], batch["active"], cfg)

    def prefill_paged(params, batch):
        return M_hybrid.hybrid_prefill_paged(
            params, cfg, tokens=batch["tokens"], lens=batch["lens"])

    def decode_paged(params, cache, batch):
        return M_hybrid.hybrid_decode_step_paged(
            params, cache, batch["tokens"], batch["active"], cfg)

    def make_paged_cache(slots, cache_len, n_blocks, block_size,
                         device=None):
        return M_hybrid.init_hybrid_paged_cache(
            cfg, slots, cache_len, n_blocks, block_size, device=device)

    return ModelBundle(
        cfg=cfg,
        init=lambda seed=0, device=None: M_hybrid.init_hybrid(seed, cfg,
                                                              device),
        specs=lambda: M_hybrid.hybrid_specs(cfg),
        apply_train=apply_train,
        prefill=prefill,
        decode_step=decode_step,
        make_cache=lambda b, s, device=None: M_hybrid.init_hybrid_cache(
            cfg, b, s, device=device),
        cache_specs=lambda: M_hybrid.hybrid_cache_specs(cfg),
        apply_hidden=lambda params, batch: M_hybrid.hybrid_hidden(
            params, cfg, tokens=batch["tokens"]),
        unembed_chunk=lambda params, x: M_hybrid.hybrid_unembed(
            params, x, cfg),
        prefill_slotted=prefill_slotted,
        decode_slotted=decode_slotted,
        make_slot_cache=lambda b, s, device=None:
            M_hybrid.init_hybrid_slot_cache(cfg, b, s, device=device),
        prefill_pads=False,
        prefill_paged=glue.recorded(prefill_paged),
        decode_paged=glue.recorded(decode_paged),
        make_paged_cache=make_paged_cache,
        paged_cache_specs=lambda: M_hybrid.hybrid_paged_cache_specs(cfg),
    )


def _encdec_bundle(cfg: ModelConfig) -> ModelBundle:
    def apply_train(params, batch):
        return M_encdec.encdec_forward(params, cfg, frames=batch["frames"],
                                       dec_tokens=batch["dec_tokens"])

    def apply_hidden(params, batch):
        return M_encdec.encdec_hidden(params, cfg, frames=batch["frames"],
                                      dec_tokens=batch["dec_tokens"])

    def prefill(params, batch):
        return M_encdec.encdec_prefill(params, cfg, frames=batch["frames"],
                                       dec_tokens=batch["dec_tokens"],
                                       cache_len=batch["cache_len"])

    def decode_step(params, cache, batch):
        return M_encdec.encdec_decode_step(params, cache, batch["tokens"],
                                           cfg)

    return ModelBundle(
        cfg=cfg,
        init=lambda seed=0, device=None: M_encdec.init_encdec(seed, cfg,
                                                              device),
        specs=lambda: M_encdec.encdec_specs(cfg),
        apply_train=apply_train,
        prefill=prefill,
        decode_step=decode_step,
        make_cache=lambda b, s, device=None: M_encdec.init_encdec_cache(
            cfg, b, s, ENCDEC_DECODE_ENC_LEN, device=device),
        cache_specs=lambda: M_encdec.encdec_cache_specs(cfg),
        apply_hidden=apply_hidden,
        unembed_chunk=lambda params, x: M_encdec.encdec_unembed(
            params, x, cfg),
    )


def build_model(cfg: ModelConfig) -> ModelBundle:
    if cfg.family in ("ssm", "hybrid"):
        return _hybrid_bundle(cfg)
    if cfg.family == "encdec":
        return _encdec_bundle(cfg)
    M_lm.check_family(cfg)
    return _lm_bundle(cfg)
