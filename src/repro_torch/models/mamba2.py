"""Mamba-2 block: SSD (state-space duality) with a chunked scan
(arXiv:2405.21060).

Counterpart of ``repro/models/mamba2.py``.  Forward = in_proj -> causal
depthwise conv (x/B/C path) -> SSD -> gated RMSNorm -> out_proj.  The scan
of a full sequence goes through ``kernels/ssd``: the hand-written CUDA
kernel for CUDA tensors, its plain version (a copy of the reference's
``ssd_chunked``) on the CPU and wherever a gradient is taken, since the
kernel has no backward (nor has ``repro``'s).  The conv, the projections
and the one-token decode step are plain PyTorch, as they are plain jnp in
the reference.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (
    is_dtensor,
    local_call,
    logical_placements,
)
from repro_torch.kernels.ssd.ops import ssd_scan
from repro_torch.kernels.ssd.ref import ssd_chunked
from repro_torch.models.common import dense_init

# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def mamba2_specs(cfg: ModelConfig, prefix: Tuple = ()) -> Dict[str, Tuple]:
    """Logical axis names of each Mamba-2 param, as ``repro``'s."""
    return {
        "in_proj": prefix + ("embed", "heads"),
        "conv_w": prefix + (None, "heads"),
        "conv_b": prefix + ("heads",),
        "dt_bias": prefix + ("heads",),
        "A_log": prefix + ("heads",),
        "D": prefix + ("heads",),
        "norm_scale": prefix + ("heads",),
        "out_proj": prefix + ("heads", "embed"),
    }


def init_mamba2(gen: torch.Generator, cfg: ModelConfig
                ) -> Dict[str, torch.Tensor]:
    """Random params from ``gen`` with the reference's distributions: dt
    log-uniform in [1e-3, 0.1] through the inverse softplus, A_log = log
    U[1, 16], conv_w uniform in +-1/sqrt(K C), D = 1, unit norm scale."""
    d, di = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * g * n
    d_in_proj = 2 * di + 2 * g * n + h
    dev = gen.device

    def uniform(shape):
        return torch.rand(shape, generator=gen, dtype=torch.float32,
                          device=dev)

    u = uniform((h,))
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    return {
        "in_proj": dense_init(gen, (d, d_in_proj), d),
        "conv_w": (uniform((cfg.conv_kernel, conv_ch)) - 0.5)
        * (2.0 / math.sqrt(cfg.conv_kernel * conv_ch)),
        "conv_b": torch.zeros((conv_ch,), dtype=torch.float32, device=dev),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "A_log": torch.log(1.0 + 15.0 * uniform((h,))),
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        "norm_scale": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, (di, d), di),
    }


# ---------------------------------------------------------------------------
# Pieces shared by the sequence and the decode forms
# ---------------------------------------------------------------------------


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv. x: (B, L, C), w: (K, C).  Under a mesh on
    local shards: the batch split, each row's L and C whole."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate

        mesh = x.device_mesh
        pl = logical_placements(x.shape, ("batch", None, None), mesh)
        whole = [Replicate()] * mesh.ndim
        return local_call(_causal_conv, (x, w, b), (pl, whole, whole), (pl,))
    k, length = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    acc = torch.zeros_like(x)
    for i in range(k):
        acc = acc + xp[:, i: i + length] * w[i]
    return acc + b


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: di + di + 2 * g * n]
    dt = zxbcdt[..., di + di + 2 * g * n:]
    return z, xbc, dt


def _split_xbc(xbc: torch.Tensor, cfg: ModelConfig):
    """(x (B,L,H,P), B (B,L,G,N), C (B,L,G,N)), each contiguous."""
    bsz, length, _ = xbc.shape
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    xs = xbc[..., :di].reshape(bsz, length, cfg.ssm_heads, cfg.ssm_head_dim)
    b_mat = xbc[..., di: di + g * n].reshape(bsz, length, g, n)
    c_mat = xbc[..., di + g * n:].reshape(bsz, length, g, n)
    return xs.contiguous(), b_mat.contiguous(), c_mat.contiguous()


def _gated_out(p, y: torch.Tensor, xs: torch.Tensor, z: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """D skip, gated RMSNorm (norm(y * silu(z))), out_proj."""
    bsz, length = y.shape[:2]
    dtype = z.dtype
    y = y + xs * p["D"][None, None, :, None].to(dtype)
    y = y.reshape(bsz, length, cfg.d_inner) * F.silu(z)
    var = y.float().square().mean(dim=-1, keepdim=True)
    y = (y.float() * torch.rsqrt(var + cfg.norm_eps)
         * p["norm_scale"]).to(dtype)
    return y @ p["out_proj"].to(dtype)


def _dt_and_a(p, dt: torch.Tensor):
    """softplus(dt + dt_bias) in f32, and A = -exp(A_log)."""
    return F.softplus(dt.float() + p["dt_bias"]), -torch.exp(p["A_log"])


def mamba2_mix(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence mixer.  x: (B, L, D).  Returns (out (B, L, D), conv
    state (B, K-1, C): the last K-1 conv inputs, final SSM state
    (B, H, N, P) f32)."""
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    conv_state = xbc[:, -(cfg.conv_kernel - 1):]
    xbc = F.silu(_causal_conv(xbc, p["conv_w"].to(x.dtype),
                              p["conv_b"].to(x.dtype)))
    xs, b_mat, c_mat = _split_xbc(xbc, cfg)
    dt_full, a_neg = _dt_and_a(p, dt)
    y, state = _scan(xs, dt_full, a_neg.float(), b_mat, c_mat, cfg)
    return _gated_out(p, y, xs, z, cfg), conv_state, state


def _ssd_placements(xs, dt, a_neg, b_mat, cfg: ModelConfig):
    """Placements of an SSD step's or scan's operands under a mesh: the
    heads split as the ``heads`` rule says where one group of B and C
    serves them all (``ssm_groups == 1``), B and C whole on every rank of
    that axis, the batch split.  Returns those of (x, dt, a_neg, B and C,
    the state (B, H, N, P))."""
    from torch.distributed.tensor import Shard

    mesh = xs.device_mesh
    axes = ("batch", None, "heads" if cfg.ssm_groups == 1 else None, None)
    x_pl = logical_placements(xs.shape, axes, mesh)
    st_pl = [Shard(1) if isinstance(pl, Shard) and pl.dim == 2 else pl
             for pl in x_pl]
    return (x_pl, logical_placements(dt.shape, axes[:3], mesh),
            logical_placements(a_neg.shape, axes[2:3], mesh),
            logical_placements(b_mat.shape, ("batch", None, None, None),
                               mesh), st_pl)


def _scan(xs, dt, a_neg, b_mat, c_mat, cfg: ModelConfig):
    """The SSD scan of a full sequence: the kernel's op, or its plain
    version under autograd; on local shards under a mesh
    (:func:`_ssd_placements`)."""
    if is_dtensor(xs):
        x_pl, dt_pl, a_pl, bc_pl, st_pl = _ssd_placements(xs, dt, a_neg,
                                                          b_mat, cfg)
        return local_call(lambda *t: _scan(*t, cfg),
                          (xs, dt, a_neg, b_mat, c_mat),
                          (x_pl, dt_pl, a_pl, bc_pl, bc_pl), (x_pl, st_pl))
    args = (xs, dt.contiguous(), a_neg, b_mat, c_mat, cfg.ssm_chunk)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xs, dt, a_neg, b_mat, c_mat)):
        return ssd_chunked(*args)      # autograd: the kernel has none
    return ssd_scan(*args)


def mamba2_block(p: Dict[str, torch.Tensor], x: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence forward. x: (B, L, D) -> (B, L, D)."""
    return mamba2_mix(p, x, cfg)[0]


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def ssd_decode_step(
    x: torch.Tensor,        # (B, 1, H, P)
    dt: torch.Tensor,       # (B, 1, H)
    a_neg: torch.Tensor,    # (H,)
    b_mat: torch.Tensor,    # (B, 1, G, N)
    c_mat: torch.Tensor,    # (B, 1, G, N)
    state: torch.Tensor,    # (B, H, N, P)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(1) recurrence for one token: h' = e^{dt A} h + dt B x; y = C h'."""
    rep = x.shape[2] // b_mat.shape[2]
    bh = b_mat[:, 0].repeat_interleave(rep, dim=1).float()   # (B, H, N)
    ch = c_mat[:, 0].repeat_interleave(rep, dim=1).float()
    decay = torch.exp(dt[:, 0] * a_neg)[..., None, None]     # (B, H, 1, 1)
    dtx = (x[:, 0] * dt[:, 0, :, None]).float()              # (B, H, P)
    state_new = state * decay + torch.einsum("bhn,bhp->bhnp", bh, dtx)
    y = torch.einsum("bhn,bhnp->bhp", ch, state_new)
    return y[:, None].to(x.dtype), state_new


def mamba2_decode(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,             # (B, 1, D)
    conv_state: torch.Tensor,    # (B, K-1, conv_ch)
    ssm_state: torch.Tensor,     # (B, H, N, P)
    cfg: ModelConfig,
):
    """One decode step. Returns (y, conv_state, ssm_state), new tensors."""
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    # rolling conv buffer: window = [conv_state ; xbc]
    win = torch.cat([conv_state, xbc], dim=1)                 # (B, K, C)
    conv_out = torch.einsum("bkc,kc->bc", win, p["conv_w"].to(x.dtype)) \
        + p["conv_b"].to(x.dtype)
    xs, b_mat, c_mat = _split_xbc(F.silu(conv_out)[:, None], cfg)
    dt_full, a_neg = _dt_and_a(p, dt)
    args = (xs, dt_full, a_neg, b_mat, c_mat, ssm_state)
    if is_dtensor(xs):
        x_pl, dt_pl, a_pl, bc_pl, st_pl = _ssd_placements(xs, dt_full, a_neg,
                                                          b_mat, cfg)
        y, ssm_state = local_call(ssd_decode_step, args, (
            x_pl, dt_pl, a_pl, bc_pl, bc_pl, st_pl), (x_pl, st_pl))
    else:
        y, ssm_state = ssd_decode_step(*args)
    return _gated_out(p, y, xs, z, cfg), win[:, 1:], ssm_state
