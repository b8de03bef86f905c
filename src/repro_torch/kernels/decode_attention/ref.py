"""Plain PyTorch version: single-token GQA attention over a padded KV cache.

Counterpart of ``repro/kernels/decode_attention/ref.py``; the oracle the
CUDA kernel is held against on the card, and the CPU path of the wrapper.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: torch.Tensor) -> torch.Tensor:
    """q: (B, H, hd); k/v: (B, S, KVH, hd); kv_len: (B,) valid prefix.

    Returns (B, H, hd) in q's dtype; scores, softmax and accumulation in
    f32."""
    b, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    qg = q.reshape(b, kvh, rep, hd).float() / (hd ** 0.5)
    scores = torch.einsum("bgrd,bsgd->bgrs", qg, k.float())
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] < kv_len.to(q.device)[:, None]        # (B, S)
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", p, v.float())
    return out.reshape(b, h, hd).to(q.dtype)
