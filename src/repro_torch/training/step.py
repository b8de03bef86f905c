"""train_step / serve_step factories over a ModelBundle.

Counterpart of ``repro/training/step.py``:

* next-token cross-entropy with z-loss and the MoE load-balance auxiliary;
* microbatched gradient accumulation (``cfg.microbatches``) in
  ``cfg.grad_acc_dtype``, a Python loop where the reference scans;
* gradient clipping by global norm, optional gradient compression;
* AdamW or Adafactor per config.

Under a mesh the params are DTensors (``distribute_params``), the batch
too, and each grad is brought to its param's placements
(:func:`_placed_like`) before the optimizer, whose state takes the
params' placements.

Gradients come from ``torch.autograd.grad`` over the param leaves, which
require grad only inside a step (:func:`requiring_grad`), so the params a
step returns are plain tensors as the reference's arrays are.  The step
runs eagerly and updates the params in place under ``no_grad``, each leaf
as ``(p + u)`` in f32 rounded once to its dtype (``apply_updates``); the
optimizer state is replaced, as the reference's is.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.distributed.compression import (
    CompressionConfig,
    compress_grads,
)
from repro_torch.distributed.sharding import (
    is_dtensor,
    local_call,
    mesh_rank,
)
from repro_torch.models.registry import ModelBundle
from repro_torch.optim import adafactor, adamw, clip_by_global_norm
from repro_torch.optim.adamw import tree_leaves, tree_map

Z_LOSS_COEF = 1e-4
MOE_AUX_COEF = 1e-2
N_LOSS_CHUNKS = 8


class TrainState(NamedTuple):
    step: int
    params: Any
    opt_state: Any


def make_optimizer(cfg: ModelConfig, lr=3e-4):
    if cfg.optimizer == "adafactor":
        return adafactor(lr)
    return adamw(lr, b1=0.9, b2=0.95, weight_decay=0.1)


def _xent_terms(logits: torch.Tensor, labels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logsumexp over the vocab, the label's logit), each (B, S) f32."""
    if is_dtensor(logits):
        return _xent_terms_sharded(logits, labels)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    return lse, gold


def _xent_terms_sharded(logits, labels):
    """:func:`_xent_terms` on local shards of DTensor logits (B, S, V).
    Split over the vocab, each rank reduces its slice: the max (an
    all-reduce of maxima, held out of the gradient), the sum of
    exponentials and the label's logit where the label is in the slice
    (all-reduced sums); the logits themselves are never gathered."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = logits.device_mesh
    pl = [Replicate() if isinstance(p, Partial) else p
          for p in logits.placements]
    row_pl = [Replicate() if isinstance(p, Shard) and p.dim == 2 else p
              for p in pl]
    v_rank, v_ways = mesh_rank(mesh, pl, 2)
    if v_ways == 1:
        return local_call(_xent_terms, (logits, labels), (pl, row_pl),
                          (row_pl, row_pl))

    def summands(op):
        return [Partial(op) if isinstance(p, Shard) and p.dim == 2 else p
                for p in pl]
    lo = v_rank * -(-logits.shape[-1] // v_ways)

    def local_terms(lg, lab, m):
        lg = lg.float()
        sum_exp = torch.exp(lg - m[..., None]).sum(dim=-1)
        at = lab.long() - lo
        inside = (at >= 0) & (at < lg.shape[-1])
        gold = lg.gather(-1, at.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
        return sum_exp, torch.where(inside, gold, torch.zeros_like(gold))
    m = local_call(lambda lg: lg.detach().float().amax(dim=-1), (logits,),
                   (pl,), (summands("max"),)).redistribute(mesh, row_pl)
    sum_exp, gold = local_call(local_terms, (logits, labels, m),
                               (pl, row_pl, row_pl),
                               (summands("sum"), summands("sum")))
    return m + torch.log(sum_exp), gold


def loss_fn(params, batch: Dict[str, Any], bundle: ModelBundle
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, {"loss": nll, "z_loss", "moe_aux"}).  With
    ``cfg.chunked_loss`` (and a sequence of 8+ chunks) the backbone's
    hidden states are unembedded a sequence chunk at a time, each chunk
    under ``torch.utils.checkpoint`` as ``jax.checkpoint`` does, so only
    one chunk's (B, S/8, V) logits exist at once."""
    labels = batch["labels"]
    s = labels.shape[1]
    if (bundle.cfg.chunked_loss and bundle.apply_hidden is not None
            and bundle.unembed_chunk is not None
            and s % N_LOSS_CHUNKS == 0 and s >= 2 * N_LOSS_CHUNKS):
        x, aux = bundle.apply_hidden(params, batch)

        def chunk_terms(xc, lc):
            return _xent_terms(bundle.unembed_chunk(params, xc), lc)

        chunk = s // N_LOSS_CHUNKS
        terms = []
        for i in range(N_LOSS_CHUNKS):
            args = (x[:, i * chunk:(i + 1) * chunk],
                    labels[:, i * chunk:(i + 1) * chunk])
            terms.append(checkpoint(chunk_terms, *args, use_reentrant=False)
                         if torch.is_grad_enabled() else chunk_terms(*args))
        lse = torch.cat([t[0] for t in terms], dim=1)
        gold = torch.cat([t[1] for t in terms], dim=1)
    else:
        logits, aux = bundle.apply_train(params, batch)
        lse, gold = _xent_terms(logits, labels)
    nll = (lse - gold).mean()
    z_loss = Z_LOSS_COEF * torch.square(lse).mean()
    total = nll + z_loss + MOE_AUX_COEF * aux
    return total, {"loss": nll, "z_loss": z_loss, "moe_aux": aux}


def _split_microbatches(batch: Dict[str, Any], m: int
                        ) -> Iterator[Dict[str, Any]]:
    """The ``m`` microbatches of ``batch``, each leaf's batch dim split in
    order ('positions' is (3, B, S): its batch dim is 1)."""
    def split(key, x):
        axis = 1 if key == "positions" else 0
        b = x.shape[axis]
        assert b % m == 0, f"batch {b} not divisible by microbatches {m}"
        return x.chunk(m, dim=axis)

    parts = {k: split(k, v) for k, v in batch.items()}
    for i in range(m):
        yield {k: v[i] for k, v in parts.items()}


@contextlib.contextmanager
def requiring_grad(params: Any):
    """The param leaves require grad inside the block, and no longer after
    it; yields them in tree order."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        yield leaves
    finally:
        for p in leaves:
            p.requires_grad_(False)


def value_and_grad(params, batch: Dict[str, Any], bundle: ModelBundle
                   ) -> Tuple[Dict[str, torch.Tensor], Any]:
    """(metrics, grads): the gradient of :func:`loss_fn`'s total with
    respect to every param leaf, in the params' tree and dtypes."""
    with requiring_grad(params) as leaves, torch.enable_grad():
        total, metrics = loss_fn(params, batch, bundle)
        grads = torch.autograd.grad(total, leaves, materialize_grads=True)
    by_leaf = {id(p): _placed_like(g, p) for p, g in zip(leaves, grads)}
    metrics = {k: v.detach() for k, v in metrics.items()}
    return metrics, tree_map(lambda p: by_leaf[id(p)], params)


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor grad on its param's placements: a sum over the ranks
    that split the batch (``Partial``) becomes the param's shard, the
    data-parallel all-reduce (a reduce-scatter where the param is
    sharded).  A plain grad is returned as it is."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(
    bundle: ModelBundle,
    optimizer=None,
    *,
    compression: Optional[CompressionConfig] = None,
    clip_norm: float = 1.0,
) -> Tuple[Callable[[TrainState, Dict[str, Any]], Tuple[TrainState, Dict]],
           Any]:
    cfg = bundle.cfg
    opt = optimizer or make_optimizer(cfg)
    m = max(cfg.microbatches, 1)
    acc_dt = torch_dtype(cfg.grad_acc_dtype)

    def grads_of(params, batch):
        if m == 1:
            return value_and_grad(params, batch, bundle)
        grads = tree_map(lambda p: torch.zeros_like(p, dtype=acc_dt),
                         params)
        metrics = None
        for mb in _split_microbatches(batch, m):
            met, g = value_and_grad(params, mb, bundle)
            tree_map(lambda a, b: a.add_(b.to(a.dtype)), grads, g)
            metrics = met if metrics is None else {
                k: metrics[k] + met[k] for k in metrics}
        grads = tree_map(lambda g: g / m, grads)
        return {k: v / m for k, v in metrics.items()}, grads

    def update(state: TrainState, grads, metrics):
        with torch.no_grad():
            if compression is not None:
                grads = compress_grads(grads, compression)
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            updates, opt_state = opt.update(grads, state.opt_state,
                                            state.params)
            tree_map(lambda p, u: p.copy_(p + u), state.params, updates)
        metrics = dict(metrics, grad_norm=gnorm)
        return TrainState(state.step + 1, state.params, opt_state), metrics

    def train_step(state: TrainState, batch: Dict[str, Any]):
        metrics, grads = grads_of(state.params, batch)
        return update(state, grads, metrics)

    # the two halves, for a profile that times them apart
    train_step.grads = grads_of
    train_step.update = update
    return train_step, opt


def make_eval_step(bundle: ModelBundle):
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = loss_fn(params, batch, bundle)
        return metrics
    return eval_step


def make_prefill_step(bundle: ModelBundle, cache_len: int):
    def prefill_step(params, batch):
        batch = dict(batch, cache_len=cache_len)
        return bundle.prefill(params, batch)
    return prefill_step


def make_decode_step(bundle: ModelBundle):
    def decode_step(params, cache, batch):
        return bundle.decode_step(params, cache, batch)
    return decode_step
