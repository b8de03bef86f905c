"""Layer library: forward implementations paired with analytic cost models.

Counterpart of ``repro/hwlib/layers.py``.  The specs and the cost model
(everything above "Parameters & forward") are the port's own copy of the
reference's numpy code; the forward is PyTorch, in two forms (see
:func:`apply_layer`).

Layout convention: activations are ``(batch, length, channels)`` float32 (the
NAS trains small candidates) with optional fake quantization applied around
each layer (see :mod:`repro_torch.hwlib.quant`).

The cost model mirrors the paper's hardware library semantics (§IV/§V):

* ``n_in``  — number of input values needed before the layer can emit its
  first output (pipeline fill; kernel size for convolutions).
* ``l``     — cycles to produce one output *position* at unrolling factor
  α = 1 (== MACs per output position, one MAC unit).
* unrolling α divides ``l`` (spatial parallelism over the dot products),
  bounded by ``alpha_max`` = MACs per output position.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.conv1d import dwsep_conv1d

# ---------------------------------------------------------------------------
# Layer specs
# ---------------------------------------------------------------------------

# Layer kinds understood by the library.
DWSEP_CONV = "dwsep_conv"  # depthwise-separable 1D convolution (+BN+ReLU)
MAXPOOL = "maxpool"        # 1D max pooling, window == stride
GLOBALPOOL = "globalpool"  # global average pooling over length
DENSE = "dense"            # fully connected head


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """A fully parametrized layer instance (one gene's phenotype)."""

    kind: str
    out_channels: int = 0   # dw-sep conv / dense
    kernel_size: int = 1    # dw-sep conv
    stride: int = 1         # dw-sep conv / maxpool
    use_bn: bool = True     # dw-sep conv only

    def short(self) -> str:
        if self.kind == DWSEP_CONV:
            return f"dw{self.kernel_size}s{self.stride}c{self.out_channels}"
        if self.kind == MAXPOOL:
            return f"mp{self.stride}"
        if self.kind == GLOBALPOOL:
            return "gap"
        return f"fc{self.out_channels}"

    def signature(self) -> Tuple:
        """The static fields that determine this layer's compiled kernel:
        parameter shapes, slice strides and the BN branch all derive from
        these, so two layers with equal signatures trace to the same jaxpr
        (the per-candidate bucketing key of the batched trainer)."""
        return (self.kind, self.out_channels, self.kernel_size, self.stride,
                self.use_bn)


@dataclasses.dataclass(frozen=True)
class LayerCost:
    """Analytic per-layer quantities consumed by the Eq.1-4 models."""

    n_in: int           # values to fill the input buffer (Eq. 1: n_in,j)
    l_cycles: float     # latency (cycles) to produce one output position, α=1
    n_out: int          # number of output positions the layer produces
    macs_per_out: int   # MACs per output position (== alpha_max)
    total_macs: int     # n_out * macs_per_out
    params: int         # parameter count (weights + bias, BN folded)
    out_len: int
    out_channels: int

    @property
    def alpha_max(self) -> int:
        return max(1, self.macs_per_out)


# ---------------------------------------------------------------------------
# Shape / cost analysis (pure python — cheap objectives must not touch torch)
# ---------------------------------------------------------------------------

def out_shape(spec: LayerSpec, in_len: int, in_ch: int) -> Tuple[int, int]:
    """(out_len, out_channels) for a layer applied to (in_len, in_ch)."""
    if spec.kind == DWSEP_CONV:
        if in_len < spec.kernel_size:
            raise ValueError(
                f"input length {in_len} < kernel {spec.kernel_size}")
        out_len = (in_len - spec.kernel_size) // spec.stride + 1
        return out_len, spec.out_channels
    if spec.kind == MAXPOOL:
        if in_len < spec.stride:
            raise ValueError(f"input length {in_len} < pool {spec.stride}")
        return in_len // spec.stride, in_ch
    if spec.kind == GLOBALPOOL:
        return 1, in_ch
    if spec.kind == DENSE:
        return 1, spec.out_channels
    raise ValueError(spec.kind)


def layer_cost(spec: LayerSpec, in_len: int, in_ch: int) -> LayerCost:
    out_len, out_ch = out_shape(spec, in_len, in_ch)
    if spec.kind == DWSEP_CONV:
        # depthwise: K MACs per channel, pointwise: C_in MACs per out channel.
        macs = spec.kernel_size * in_ch + in_ch * out_ch
        params = spec.kernel_size * in_ch + in_ch * out_ch + out_ch  # +bias
        n_in = spec.kernel_size
    elif spec.kind == MAXPOOL:
        macs = spec.stride * in_ch  # comparisons ~ MAC-equivalents
        params = 0
        n_in = spec.stride
    elif spec.kind == GLOBALPOOL:
        macs = in_len * in_ch  # running sum — counted once for its single out
        params = 0
        n_in = in_len
    else:  # DENSE
        macs = in_ch * out_ch
        params = in_ch * out_ch + out_ch
        n_in = in_ch
    return LayerCost(
        n_in=n_in,
        l_cycles=float(macs),
        n_out=out_len,
        macs_per_out=macs,
        total_macs=out_len * macs,
        params=params,
        out_len=out_len,
        out_channels=out_ch,
    )


# ---------------------------------------------------------------------------
# Batched (population-wide) cost tabulation — DESIGN.md §2
# ---------------------------------------------------------------------------

# Integer kind codes for vectorized dispatch (order is arbitrary but fixed).
KIND_CODES = {DWSEP_CONV: 0, MAXPOOL: 1, GLOBALPOOL: 2, DENSE: 3}


@dataclasses.dataclass(frozen=True)
class OpCostTable:
    """Static per-op cost coefficients of an op catalogue, as arrays.

    Indexed by op id.  Every :class:`LayerCost` quantity of every op kind is
    an affine function of the running input ``(length, channels)`` state::

        out_len  = (length - (ek_const + ek_is_len*length)) // es + 1
        out_ch   = oc_const + oc_is_ch * channels
        macs     = macs_c * channels + macs_lc * length * channels
        params   = p_const + p_ch * channels
        n_in     = ni_const + ni_is_len*length + ni_is_ch*channels

    so a population's costs tabulate as one gather per coefficient plus flat
    vectorized arithmetic — no per-kind branching in the hot loop.
    """

    kind: np.ndarray        # (n_ops,) int64 — KIND_CODES value
    ek_const: np.ndarray    # effective window: conv kernel / pool stride
    ek_is_len: np.ndarray   # 1 where the window is the whole input (gap/fc)
    es: np.ndarray          # output stride
    macs_c: np.ndarray      # MACs per output position, per input channel
    macs_lc: np.ndarray     # ... per input value (gap running sum)
    p_const: np.ndarray     # params independent of input channels (bias)
    p_ch: np.ndarray        # params per input channel
    ni_const: np.ndarray    # pipeline-fill values (Eq. 1 n_in), constant part
    ni_is_len: np.ndarray   # 1 where n_in == input length (gap)
    ni_is_ch: np.ndarray    # 1 where n_in == input channels (dense)
    oc_const: np.ndarray    # output channels, constant part (conv/dense)
    oc_is_ch: np.ndarray    # 1 where channels pass through (pool/gap)

    @classmethod
    def from_specs(cls, specs: Sequence[LayerSpec]) -> "OpCostTable":
        rows = []
        for s in specs:
            k, st, och = s.kernel_size, s.stride, s.out_channels
            code = KIND_CODES.get(s.kind)
            if s.kind == DWSEP_CONV:
                rows.append((code, k, 0, st, k + och, 0, och, k + och,
                             k, 0, 0, och, 0))
            elif s.kind == MAXPOOL:
                rows.append((code, st, 0, st, st, 0, 0, 0, st, 0, 0, 0, 1))
            elif s.kind == GLOBALPOOL:
                rows.append((code, 0, 1, 1, 0, 1, 0, 0, 0, 1, 0, 0, 1))
            elif s.kind == DENSE:
                rows.append((code, 0, 1, 1, och, 0, och, och, 0, 0, 1,
                             och, 0))
            else:
                raise ValueError(s.kind)
        cols = np.asarray(rows, np.int64).T
        return cls(*cols)


@dataclasses.dataclass(frozen=True)
class LayerCostArrays:
    """:class:`LayerCost` for a whole population, as ``(N, T)`` arrays.

    ``T`` is the padded phenotype length (max searchable depth + GAP + dense
    head); padded positions are masked out by ``valid`` and hold zeros.  All
    quantities match the scalar :func:`layer_cost` exactly on valid slots.
    """

    n_in: np.ndarray          # (N, T) int64
    l_cycles: np.ndarray      # (N, T) float64
    n_out: np.ndarray         # (N, T) int64
    macs_per_out: np.ndarray  # (N, T) int64
    total_macs: np.ndarray    # (N, T) int64
    params: np.ndarray        # (N, T) int64
    out_len: np.ndarray       # (N, T) int64
    out_channels: np.ndarray  # (N, T) int64
    valid: np.ndarray         # (N, T) bool
    n_layers: np.ndarray      # (N,)  int64 — valid layer count per genome

    @property
    def alpha_max(self) -> np.ndarray:
        return np.maximum(1, self.macs_per_out)

    @property
    def last_index(self) -> np.ndarray:
        """Column index of each genome's final (dense head) layer."""
        return self.n_layers - 1

    def __len__(self) -> int:
        return self.n_in.shape[0]


def batch_layer_costs(table: OpCostTable, ops: np.ndarray, valid: np.ndarray,
                      in_len: np.ndarray, in_ch: int = 2) -> LayerCostArrays:
    """Vectorized shape/cost propagation for a padded population.

    ``ops`` is ``(N, T)`` op ids into ``table`` (``-1``-padded), ``valid`` the
    matching mask, ``in_len`` the ``(N,)`` input lengths.  The layer axis is
    walked sequentially (T is tiny); each step is vectorized over the
    population.  Callers must pass pre-validated genomes: shapes are computed
    with the scalar rules but nothing raises on a degenerate layer.
    """
    n, t_pad = ops.shape
    safe = np.maximum(ops, 0)
    ek = table.ek_const[safe]
    ekl = table.ek_is_len[safe]
    es = table.es[safe]
    occ = table.oc_const[safe]
    occh = table.oc_is_ch[safe]
    # sequential part: only the (length, channels) trajectory is recurrent
    l_in = np.empty((n, t_pad), np.int64)
    c_in = np.empty((n, t_pad), np.int64)
    o_len = np.empty((n, t_pad), np.int64)
    length = in_len.astype(np.int64)
    ch = np.full(n, in_ch, np.int64)
    for t in range(t_pad):
        l_in[:, t] = length
        c_in[:, t] = ch
        out_len = (length - (ek[:, t] + ekl[:, t] * length)) // es[:, t] + 1
        out_ch = occ[:, t] + occh[:, t] * ch
        o_len[:, t] = out_len
        v = valid[:, t]
        length = np.where(v, out_len, length)
        ch = np.where(v, out_ch, ch)
    # flat part: every cost column is affine in the recorded trajectory
    vi = valid.astype(np.int64)
    o_len *= vi
    macs = (table.macs_c[safe] * c_in
            + table.macs_lc[safe] * l_in * c_in) * vi
    return LayerCostArrays(
        n_in=(table.ni_const[safe] + table.ni_is_len[safe] * l_in
              + table.ni_is_ch[safe] * c_in) * vi,
        l_cycles=macs.astype(np.float64),
        n_out=o_len,
        macs_per_out=macs,
        total_macs=o_len * macs,
        params=(table.p_const[safe] + table.p_ch[safe] * c_in) * vi,
        out_len=o_len,
        out_channels=(occ + occh * c_in) * vi,
        valid=valid,
        n_layers=valid.sum(axis=1).astype(np.int64),
    )


# ---------------------------------------------------------------------------
# Parameters & forward
# ---------------------------------------------------------------------------

def init_layer(gen: torch.Generator, spec: LayerSpec, in_ch: int
               ) -> Dict[str, Any]:
    """He-style init, the reference's shapes and scales, drawn on the CPU
    from ``gen``. Returns {} for parameter-free layers."""
    if spec.kind == DWSEP_CONV:
        fan_dw = spec.kernel_size
        fan_pw = in_ch
        params: Dict[str, Any] = {
            "dw": torch.randn((spec.kernel_size, in_ch), generator=gen)
            * math.sqrt(2.0 / fan_dw),
            "pw": torch.randn((in_ch, spec.out_channels), generator=gen)
            * math.sqrt(2.0 / fan_pw),
            "b": torch.zeros((spec.out_channels,)),
        }
        if spec.use_bn:
            params["bn_scale"] = torch.ones((spec.out_channels,))
            params["bn_bias"] = torch.zeros((spec.out_channels,))
            # running stats: params in the tree, as in the reference
            # (re-estimated by core/trainer.py: refresh_bn_stats)
            params["bn_mean"] = torch.zeros((spec.out_channels,))
            params["bn_var"] = torch.ones((spec.out_channels,))
        return params
    if spec.kind == DENSE:
        return {
            "w": torch.randn((in_ch, spec.out_channels), generator=gen)
            * math.sqrt(1.0 / in_ch),
            "b": torch.zeros((spec.out_channels,)),
        }
    return {}


def _depthwise_conv1d(x: torch.Tensor, w: torch.Tensor, stride: int
                      ) -> torch.Tensor:
    """x: (B, L, C), w: (K, C) -> (B, L_out, C). VALID padding: K strided
    views, multiplied and summed in tap order."""
    k = w.shape[0]
    l_out = (x.shape[1] - k) // stride + 1
    acc = torch.zeros((x.shape[0], l_out, x.shape[2]), dtype=x.dtype,
                      device=x.device)
    for i in range(k):
        acc = acc + x[:, i: i + (l_out - 1) * stride + 1: stride] * w[i]
    return acc


def _kernel_form(train: bool) -> bool:
    """The hand-written conv kernel has no backward: it runs where no
    gradient is taken (eval, BN re-estimation, profiling, deployment)."""
    return not train and not torch.is_grad_enabled()


def conv_pre_activation(params: Dict[str, Any], spec: LayerSpec,
                        x: torch.Tensor, *, train: bool = False
                        ) -> torch.Tensor:
    """The dw-sep conv before BN and ReLU: ``dw conv -> x @ pw + b``; one
    kernel launch (``relu=False``) where no gradient is taken."""
    if _kernel_form(train):
        return dwsep_conv1d(x.contiguous(), params["dw"], params["pw"],
                            params["b"], stride=spec.stride, relu=False)
    h = _depthwise_conv1d(x, params["dw"], spec.stride)
    return torch.einsum("blc,cd->bld", h, params["pw"]) + params["b"]


def apply_layer(
    params: Dict[str, Any],
    spec: LayerSpec,
    x: torch.Tensor,
    *,
    train: bool = False,
) -> torch.Tensor:
    """Forward one layer. x: (B, L, C) except DENSE, which takes (B, C).

    A dw-sep conv takes one of two forms.  With ``train=True`` or grad
    enabled it is torch ops under autograd (the reference's jnp body).
    Otherwise it goes through the conv kernel
    (``kernels/conv1d.dwsep_conv1d``): one launch with the ReLU fused when
    the params hold no BN keys (BN-folded deployment params), else one
    launch without ReLU followed by the BN affine and the ReLU in torch."""
    if spec.kind == DWSEP_CONV:
        # BN-folded params drop the bn_* keys: the spec may still say use_bn
        bn = spec.use_bn and "bn_scale" in params
        if not bn and _kernel_form(train):
            return dwsep_conv1d(x.contiguous(), params["dw"], params["pw"],
                                params["b"], stride=spec.stride, relu=True)
        h = conv_pre_activation(params, spec, x, train=train)
        if bn:
            if train:
                mean = h.mean(dim=(0, 1))
                var = h.var(dim=(0, 1), unbiased=False)
            else:
                mean, var = params["bn_mean"], params["bn_var"]
            h = (h - mean) * torch.rsqrt(var + 1e-5)
            h = h * params["bn_scale"] + params["bn_bias"]
        return torch.relu(h)
    if spec.kind == MAXPOOL:
        s = spec.stride
        l_out = x.shape[1] // s
        h = x[:, : l_out * s].reshape(x.shape[0], l_out, s, x.shape[2])
        return h.amax(dim=2)
    if spec.kind == GLOBALPOOL:
        return x.mean(dim=1)  # (B, C)
    if spec.kind == DENSE:
        return x @ params["w"] + params["b"]
    raise ValueError(spec.kind)
