"""Plain PyTorch versions of the Mamba-2 SSD scan.

:func:`ssd_chunked` is the counterpart of ``repro/models/mamba2.py:
ssd_chunked``, the function ``repro`` runs in every Mamba-2 prefill: the
CPU path of the wrapper in ``ops.py``, the path taken under autograd, and
the oracle the CUDA kernel is held against on the card.  :func:`ssd_ref`
is the counterpart of ``repro/kernels/ssd/ref.py: ssd_ref``, the naive
per-step recurrence both are tested against.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def ssd_chunked(
    x: torch.Tensor,        # (B, L, H, P) inputs per head
    dt: torch.Tensor,       # (B, L, H)    positive step sizes
    a_neg: torch.Tensor,    # (H,)         A = -exp(A_log), negative
    b_mat: torch.Tensor,    # (B, L, G, N)
    c_mat: torch.Tensor,    # (B, L, G, N)
    chunk: int,
    h0: Optional[torch.Tensor] = None,  # (B, H, N, P) initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked scan. Returns (y (B,L,H,P) in x's dtype, final state
    (B,H,N,P) f32).

    L is padded up to a multiple of the chunk with zeros, dt included
    (after the softplus), so the padded steps neither decay nor feed the
    state.  The intra-chunk decay ``exp(cum[t] - cum[s])`` is formed only
    for s <= t: the exponent is set to -inf above the diagonal before the
    ``exp``, where the reference selects with ``where`` after it (for
    s > t the difference can overflow ``exp`` to inf, and inf * 0 is NaN).

    The cumulative log-decay and its exponentials are taken in f64 and
    rounded once to f32; everything else is f32, as in the reference.  In
    f32, ``cum[t] - cum[s]`` cancels: it loses ``|cum| * 2**-24`` of the
    decay's relative accuracy, 1.2e-4 on an H100 at steps of dt up to 5
    over a 64-step chunk (tests/test_torch_cuda.py), where the step-by-step
    kernel loses nothing.  As the kernel's oracle, this version should not
    carry that error of its own.
    """
    bsz, l, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    rep = h // g
    q = min(chunk, l)
    nc = -(-l // q)
    pad = nc * q - l
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
    bh = b_mat.repeat_interleave(rep, dim=2).float()   # (B, L', H, N)
    ch = c_mat.repeat_interleave(rep, dim=2).float()
    loga = (dt * a_neg).float()                         # (B, L', H)
    dtx = (x * dt[..., None]).float()                   # (B, L', H, P)

    def chunks(t):
        return t.reshape((bsz, nc, q) + t.shape[2:])

    xs, las, bs, cs = chunks(dtx), chunks(loga), chunks(bh), chunks(ch)
    state = (torch.zeros((bsz, h, n, p), dtype=torch.float32,
                         device=x.device) if h0 is None else h0.float())
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    ys = []
    for c in range(nc):
        xc, lac, bc, cc = xs[:, c], las[:, c], bs[:, c], cs[:, c]
        cum = torch.cumsum(lac.double(), dim=1)          # (B, Q, H) f64
        # inter-chunk: y[t] = exp(cum[t]) * C_t . state
        y_inter = torch.einsum("bqhn,bhnp->bqhp", cc, state) \
            * torch.exp(cum).float()[..., None]
        # intra-chunk: m[t, s] = (C_t . B_s) * exp(cum[t] - cum[s]), s <= t
        scores = torch.einsum("bqhn,bshn->bqsh", cc, bc)
        dd = cum[:, :, None, :] - cum[:, None, :, :]     # (B, Q, S, H)
        dd = torch.where(mask[None, :, :, None], dd,
                         torch.full_like(dd, float("-inf")))
        y_intra = torch.einsum("bqsh,bshp->bqhp",
                               scores * torch.exp(dd).float(), xc)
        # state' = exp(total) * state + sum_s exp(total - cum[s]) B_s x_s
        total = cum[:, -1, :]                            # (B, H)
        w = torch.exp(total[:, None, :] - cum).float()   # (B, Q, H)
        state = state * torch.exp(total).float()[..., None, None] \
            + torch.einsum("bqhn,bqhp,bqh->bhnp", bc, xc, w)
        ys.append(y_inter + y_intra)
    y = torch.cat(ys, dim=1)[:, :l]
    return y.to(x.dtype), state


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a_neg: torch.Tensor,
            b_mat: torch.Tensor, c_mat: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Naive recurrence, one step at a time from a zero state:
    h_t = exp(dt_t A) h_{t-1} + B_t (dt_t x_t);  y_t = C_t . h_t.
    Returns (y (B,L,H,P) in x's dtype, final state (B,H,N,P) f32)."""
    bsz, l, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    rep = h // g
    bh = b_mat.repeat_interleave(rep, dim=2).float()
    ch = c_mat.repeat_interleave(rep, dim=2).float()
    dtx = x.float() * dt[..., None]
    decay = torch.exp(dt * a_neg).float()
    state = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(l):
        state = state * decay[:, t, :, None, None] \
            + torch.einsum("bhn,bhp->bhnp", bh[:, t], dtx[:, t])
        ys.append(torch.einsum("bhn,bhnp->bhp", ch[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype), state
