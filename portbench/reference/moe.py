"""Plain PyTorch reference of the routed mixture-of-experts LM, in float32.

The dense reference's block (``portbench/reference/dense.py``) with the
MLP replaced by the configuration's routed experts, as DBRX publishes
them: a router (d_model -> n_experts), softmax, the top
``experts_per_token`` experts per token (ties to the lower expert id),
their gates renormalised to sum to 1, and a SwiGLU expert each.

One departure from published DBRX, which routes without drops: the
configuration states a capacity, as the served system runs it.  Of the
tokens of one call (every row of a prefill bucket, pad positions
included, or every row of a decode step), each expert takes at most
``C = max(8, ceil8(ceil(T k / E * capacity_factor)))`` of the (token,
choice) pairs routed to it, the first C in (token, choice) order; a pair
past it adds nothing (the token keeps its residual).  So a call's rows
are computed together, as one batch.

Where asked, :func:`run` also records each token's routing margin at
every layer: its k-th router logit less its (k+1)-th.  A token whose
margin is small at some layer is one that a rounding of its hidden state
can route otherwise (``portbench/harness/check.py``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from portbench.reference.dense import Row, act, first_layer_kv, fp8, \
    run as _run, weight

__all__ = ["Row", "run", "experts", "capacity", "fp8", "first_layer_kv",
           "min_margin"]


def capacity(n_tokens: int, cfg: Dict) -> int:
    cap = math.ceil(n_tokens * cfg["experts_per_token"] / cfg["n_experts"]
                    * cfg["capacity_factor"])
    return max(8, -(-cap // 8) * 8)


def experts(lp: Dict, x: torch.Tensor, cfg: Dict, prec: str,
            margins: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """The routed experts over x (T, D): the call's T tokens together.
    Appends each token's routing margin to ``margins`` where given."""
    m = lp["moe"]
    t = x.shape[0]
    k, n_exp = cfg["experts_per_token"], cfg["n_experts"]
    logits = act(x, prec) @ weight(m["router"], prec)
    if margins is not None:
        ranked = logits.topk(k + 1, dim=-1).values
        margins.append(ranked[:, k - 1] - ranked[:, k])
    probs = torch.softmax(logits, dim=-1)
    top, chosen = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = top[:, :k] / top[:, :k].sum(-1, keepdim=True)
    chosen = chosen[:, :k].reshape(-1)              # (T*k,) token-major
    gates = gates.reshape(-1)
    cap = capacity(t, cfg)
    out = torch.zeros_like(x)
    for e in range(n_exp):
        pairs = torch.nonzero(chosen == e).squeeze(1)[:cap]
        if pairs.numel() == 0:
            continue
        tok = pairs // k
        xe = act(x[tok], prec)
        he = F.silu(xe @ weight(m["gate"][e], prec)) \
            * (xe @ weight(m["up"][e], prec))
        ye = act(he, prec) @ weight(m["down"][e], prec)
        out.index_add_(0, tok, ye * gates[pairs, None])
    return out


def min_margin(margins: List[torch.Tensor]) -> torch.Tensor:
    """Each token's smallest routing margin over the layers recorded."""
    return torch.stack(margins).min(0).values


def run(params: Dict, cfg: Dict, rows, prec: str = "f32",
        keep_kv: bool = False,
        margins: Optional[List[torch.Tensor]] = None):
    """The dense reference's :func:`run` with the routed experts; with
    ``margins`` a list, each layer's routing margins (T,) over the call's
    tokens, in row order, are appended to it."""
    def ffn(lp, x, cfg, prec):
        return experts(lp, x, cfg, prec, margins)
    return _run(params, cfg, rows, prec=prec, ffn=ffn, keep_kv=keep_kv)
