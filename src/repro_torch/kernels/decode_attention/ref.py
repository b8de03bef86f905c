"""Plain PyTorch versions: single-token GQA attention over a padded KV
cache, and over a paged block pool.

Counterpart of ``repro/kernels/decode_attention/ref.py``; the oracles the
CUDA kernel's two entry points are held against on the card, and the CPU
paths of the wrappers.
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


def gather_paged_kv(k_pages: torch.Tensor, v_pages: torch.Tensor,
                    tables: torch.Tensor):
    """Materialise each row's logical cache from the block pool.

    k/v_pages: (P, BS, KVH, hd) pools; tables: (B, NB) int32 block tables
    (entries >= P are unallocated sentinels: clamped, then masked by
    ``kv_len`` downstream).  Returns dense (B, NB*BS, KVH, hd) copies."""
    p, bs, kvh, hd = k_pages.shape
    b, nb = tables.shape
    tbl = tables.long().clamp(max=p - 1)
    k = k_pages[tbl].reshape(b, nb * bs, kvh, hd)
    v = v_pages[tbl].reshape(b, nb * bs, kvh, hd)
    return k, v


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, tables: torch.Tensor,
                               kv_len: torch.Tensor) -> torch.Tensor:
    """Dense-gather version of paged decode attention: q (B, H, hd);
    k/v_pages (P, BS, KVH, hd); tables (B, NB); kv_len (B,).  With
    ``NB*BS`` equal to a dense cache's S and identity tables it is
    :func:`decode_attention_ref` on the same numbers, bit for bit."""
    k, v = gather_paged_kv(k_pages, v_pages, tables)
    return decode_attention_ref(q, k, v, kv_len)
