"""Plain PyTorch version of GQA attention, causal or not.

Counterpart of ``repro/kernels/flash_attention/ref.py: attention_ref``,
flag for flag: the CPU path of the wrapper in ``ops.py`` and the oracle
the CUDA kernel is held against on the card.  Scores are materialised a
block of queries at a time, so a long prompt does not hold the whole
(Sq, Sk) score matrix at once.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
Q_BLOCK = 512


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Sk, KVH, hd) with H % KVH == 0.  Causal:
    query i attends to keys 0..i (``attention_ref``'s top-left mask, also
    where Sq != Sk); otherwise to every key.  Head h reads KV head
    h // (H // KVH).  q is scaled by 1/sqrt(hd) in f32 before the dot, as
    ``chunked_attention`` does; scores, softmax and sums in f32.  Returns
    (B, Sq, H, hd) in q's dtype."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    qg = q.reshape(b, sq, kvh, rep, hd).float() * (1.0 / hd ** 0.5)
    kf, vf = k.float(), v.float()
    outs = []
    for lo in range(0, sq, Q_BLOCK):
        hi = min(lo + Q_BLOCK, sq)
        end = min(hi, sk) if causal else sk       # keys the block can see
        sc = torch.einsum("bqgrd,bkgd->bqgrk", qg[:, lo:hi], kf[:, :end])
        if causal:
            mask = (torch.arange(lo, hi, device=q.device)[:, None]
                    >= torch.arange(end, device=q.device)[None, :])
            sc = torch.where(mask[None, :, None, None, :], sc,
                             torch.full_like(sc, NEG_INF))
        p = torch.softmax(sc, dim=-1)
        outs.append(torch.einsum("bqgrk,bkgd->bqgrd", p, vf[:, :end]))
    return torch.cat(outs, dim=1).reshape(b, sq, h, hd).to(q.dtype)
