"""Plain PyTorch version of causal GQA attention over a full sequence.

Counterpart of ``repro/kernels/flash_attention/ref.py: attention_ref``
with ``causal=True`` and Sq == Sk: the CPU path of the wrapper in
``ops.py`` and the oracle the CUDA kernel is held against on the card.
Scores are materialised a block of queries at a time, so a long prompt
does not hold the whole (S, S) score matrix at once.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
Q_BLOCK = 512


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, S, KVH, hd) with H % KVH == 0.  Query i
    attends to keys 0..i; head h reads KV head h // (H // KVH).  q is
    scaled by 1/sqrt(hd) in f32 before the dot, as ``chunked_attention``
    does; scores, softmax and sums in f32.  Returns (B, S, H, hd) in q's
    dtype."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    qg = q.reshape(b, s, kvh, rep, hd).float() * (1.0 / hd ** 0.5)
    kf, vf = k.float(), v.float()
    outs = []
    for lo in range(0, s, Q_BLOCK):
        hi = min(lo + Q_BLOCK, s)
        sc = torch.einsum("bqgrd,bkgd->bqgrk", qg[:, lo:hi], kf[:, :hi])
        mask = (torch.arange(lo, hi, device=q.device)[:, None]
                >= torch.arange(hi, device=q.device)[None, :])
        sc = torch.where(mask[None, :, None, None, :], sc,
                         torch.full_like(sc, NEG_INF))
        p = torch.softmax(sc, dim=-1)
        outs.append(torch.einsum("bqgrk,bkgd->bqgrd", p, vf[:, :hi]))
    return torch.cat(outs, dim=1).reshape(b, s, h, hd).to(q.dtype)
