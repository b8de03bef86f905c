"""Plain PyTorch reference of the dense decoder-only LM, in float32.

It follows the published Llama-style block that the configuration file
describes: RMSNorm (eps ``norm_eps``), grouped-query attention with RoPE
(half-split rotation, base ``rope_theta``) and a causal mask, a SwiGLU
MLP, a final RMSNorm and an untied unembedding.  Every matrix product is
float32 (the caller turns TF32 off), with no kernel, cache or batching of
the program: it imports nothing of the program and reads only the
weights the benchmark drew.

:func:`run` computes rows of tokens, each at its own positions after an
optional past of keys and values, through every layer.  The feed-forward
sees all rows' tokens at once, so a family whose feed-forward couples the
tokens of one call (``moe``) runs its call's rows together.

``prec="fp8"`` is the control: every weight (per output column) and every
matrix product's input (per row), the keys and values included, rounded
to float8 e4m3 and scaled back.  It is the precision below the served
bfloat16 that a later change could be tempted to serve in.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0
Q_BLOCK = 256          # queries per attention block
TOKEN_BLOCK = 4096     # tokens per feed-forward block


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (the reduced axis), back in float32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def weight(w: torch.Tensor, prec: str) -> torch.Tensor:
    """An (in, out) weight as the reference multiplies by it."""
    w = w.float()
    return w if prec == "f32" else fp8(w, 0)


def act(x: torch.Tensor, prec: str) -> torch.Tensor:
    """A product's (rows, in) input as the reference feeds it."""
    return x if prec == "f32" else fp8(x, -1)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float
            ) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, hd) at absolute positions ``pos`` (S,): the first half of
    hd rotates against the second."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = (pos.double()[:, None] * inv).float()[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    c, s = torch.cos(ang), torch.sin(ang)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_pos: torch.Tensor) -> torch.Tensor:
    """Causal GQA: q (S, H, hd) at positions ``q_pos``; k, v (T, KVH, hd)
    at positions 0..T-1; query i sees keys j <= q_pos[i]."""
    s, h, hd = q.shape
    t, kvh, _ = k.shape
    rep = h // kvh
    kt = k.permute(1, 2, 0)                              # (KVH, hd, T)
    vt = v.permute(1, 0, 2)                              # (KVH, T, hd)
    keys = torch.arange(t, device=q.device)
    out = []
    for lo in range(0, s, Q_BLOCK):
        qb = q[lo:lo + Q_BLOCK]                          # (b, H, hd)
        b = qb.shape[0]
        qg = qb.reshape(b, kvh, rep, hd).permute(1, 0, 2, 3) \
            .reshape(kvh, b * rep, hd)
        sc = torch.bmm(qg, kt) * hd ** -0.5              # (KVH, b*rep, T)
        sc = sc.view(kvh, b, rep, t)
        mask = keys[None, :] > q_pos[lo:lo + Q_BLOCK, None]
        sc = sc.masked_fill(mask[None, :, None, :], float("-inf"))
        p = torch.softmax(sc, dim=-1).view(kvh, b * rep, t)
        o = torch.bmm(p, vt).view(kvh, b, rep, hd).permute(1, 0, 2, 3)
        out.append(o.reshape(b, h, hd))
    return torch.cat(out)


@dataclasses.dataclass
class Row:
    """One row of a call: its tokens, its first position (the length of its
    past), a past of keys and values per layer (``past(layer) -> (k, v)``,
    each (start, KVH, hd)) where ``start`` > 0, and the positions whose
    logits are wanted (indices into ``tokens``).  With ``past_only`` the
    past also holds the row's own positions (start + len(tokens) rows),
    and attention reads it alone: each token is computed from the keys
    and values given, as one decode step after another would be."""
    tokens: torch.Tensor
    start: int = 0
    past: Optional[Callable[[int], tuple]] = None
    logits_at: Optional[torch.Tensor] = None
    past_only: bool = False


def mlp(lp: Dict, x: torch.Tensor, cfg: Dict, prec: str) -> torch.Tensor:
    """SwiGLU over x (N, D), in blocks of tokens."""
    m = lp["mlp"]
    wg, wu, wd = (weight(m[k], prec) for k in ("gate", "up", "down"))
    out = []
    for lo in range(0, x.shape[0], TOKEN_BLOCK):
        xb = act(x[lo:lo + TOKEN_BLOCK], prec)
        hb = F.silu(xb @ wg) * (xb @ wu)
        out.append(act(hb, prec) @ wd)
    return torch.cat(out)


def first_layer_kv(params: Dict, cfg: Dict, tokens: torch.Tensor,
                   prec: str = "f32") -> tuple:
    """The first layer's keys and values (each (S, KVH, hd)) of ``tokens``
    at positions 0..S-1: they depend on each token and its position alone."""
    d, h, kvh = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or d // h
    lp = params["layers"][0]
    dev = params["embed"].device
    x = params["embed"].index_select(0, tokens.to(dev).long()).float()
    xn = act(rmsnorm(x, lp["attn_norm"]["scale"], cfg["norm_eps"]), prec)
    pos = torch.arange(len(tokens), device=dev)
    k = rope((xn @ weight(lp["attn"]["k"], prec)).view(-1, kvh, hd), pos,
             cfg["rope_theta"])
    v = (xn @ weight(lp["attn"]["v"], prec)).view(-1, kvh, hd)
    if prec != "f32":
        k, v = fp8(k, -1), fp8(v, -1)
    return k, v


def run(params: Dict, cfg: Dict, rows: List[Row], prec: str = "f32",
        ffn: Callable = mlp, keep_kv: bool = False):
    """Every row through every layer.  Returns (logits per row at its
    ``logits_at`` (n, V), and where ``keep_kv`` the new keys and values per
    row and layer, [row][layer] -> (k, v) each (S, KVH, hd))."""
    d, h, kvh = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or d // h
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    dev = params["embed"].device
    sizes = [len(r.tokens) for r in rows]
    ids = torch.cat([r.tokens.to(dev).long() for r in rows])
    x = params["embed"].index_select(0, ids).float()
    pos = [torch.arange(r.start, r.start + n, device=dev)
           for r, n in zip(rows, sizes)]
    kv_out = [[] for _ in rows]
    for i, lp in enumerate(params["layers"]):
        a = lp["attn"]
        xn = act(rmsnorm(x, lp["attn_norm"]["scale"], eps), prec)
        q = (xn @ weight(a["q"], prec)).view(-1, h, hd)
        k = (xn @ weight(a["k"], prec)).view(-1, kvh, hd)
        v = (xn @ weight(a["v"], prec)).view(-1, kvh, hd)
        outs, lo = [], 0
        for j, (r, n) in enumerate(zip(rows, sizes)):
            qr = rope(q[lo:lo + n], pos[j], theta)
            kr = rope(k[lo:lo + n], pos[j], theta)
            vr = v[lo:lo + n]
            if prec != "f32":
                kr, vr = fp8(kr, -1), fp8(vr, -1)
            if keep_kv:
                kv_out[j].append((kr, vr))
            kk, vv = kr, vr
            if r.start or r.past_only:
                pk, pv = (t.float() for t in r.past(i))
                if prec != "f32":
                    pk, pv = fp8(pk, -1), fp8(pv, -1)
                kk, vv = (pk, pv) if r.past_only else (torch.cat([pk, kr]),
                                                       torch.cat([pv, vr]))
            outs.append(attend(act(qr, prec), kk, vv, pos[j]))
            lo += n
        o = torch.cat(outs).reshape(-1, h * hd)
        x = x + act(o, prec) @ weight(a["o"], prec)
        x = x + ffn(lp, act(rmsnorm(x, lp["mlp_norm"]["scale"], eps), prec),
                    cfg, prec)
    want, lo = [], 0
    for r, n in zip(rows, sizes):
        at = (torch.arange(n, device=dev) if r.logits_at is None
              else r.logits_at.to(dev))
        want.append(x[lo + at])
        lo += n
    xf = rmsnorm(torch.cat(want), params["final_norm"]["scale"], eps)
    logits = act(xf, prec) @ weight(params["unembed"], prec)
    return logits, kv_out
