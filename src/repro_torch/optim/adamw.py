"""AdamW as an (init, update) pair over param trees.

Counterpart of ``repro/optim/adamw.py``, term for term.  A tree is what
the port's params are: lists and dicts with tensors at the leaves (a tuple
is a leaf); leaves are visited in the reference's order (dict keys sorted,
as ``jax.tree_util`` flattens them).  Updates are computed out of place,
like the reference's.

Adafactor (factored second moment, no first moment) is provided for the
1T-parameter configs where AdamW's 12 bytes/param of state cannot fit.
It factors and RMS-clips per leaf, so it works on the reference's layout:
where the port keeps a list of like subtrees (a model's layers), the
reference stacks them on a leading axis, and Adafactor stacks them too
(:func:`stack_lists`); its state keeps that stacked layout.

Interface mirrors optax: ``opt = adamw(lr); state = opt.init(params);
updates, state = opt.update(grads, state, params); params =
apply_updates(params, updates)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Tuple, Union

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and of the same-shaped trees in
    ``rest``), keeping the lists and dicts around them."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in ``jax.tree_util.tree_leaves`` order: dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def apply_updates(params: Any, updates: Any) -> Any:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in tree_leaves(grads)))
    scale = torch.clamp_max(max_norm / (gn + 1e-9), 1.0)
    # promoted as jnp promotes a bf16 grad times the f32 scale: to f32
    return tree_map(lambda g: g.to(torch.promote_types(g.dtype, scale.dtype))
                    * scale, grads), gn


def stack_lists(tree: Any) -> Any:
    """The reference's layout of a port tree: every list of like subtrees
    (same keys, same leaf shapes) becomes one subtree whose leaves are
    stacked on a new leading axis, innermost lists first, so a hybrid's
    ``groups`` (a list of lists) stacks as ``(n_groups, period, ...)``."""
    if isinstance(tree, dict):
        return {k: stack_lists(v) for k, v in tree.items()}
    if isinstance(tree, list):
        items = [stack_lists(v) for v in tree]
        return tree_map(lambda *xs: torch.stack(xs), items[0], *items[1:])
    return tree


def unstack_like(stacked: Any, like: Any) -> Any:
    """Inverse of :func:`stack_lists`: ``stacked`` split back into the
    lists of ``like``."""
    if isinstance(like, dict):
        return {k: unstack_like(stacked[k], v) for k, v in like.items()}
    if isinstance(like, list):
        return [unstack_like(tree_map(lambda x, i=i: x[i], stacked), v)
                for i, v in enumerate(like)]
    return stacked


def _lr_fn(lr: Union[Callable, float]) -> Callable[[int], float]:
    """``lr`` as a function of the (1-based) step, evaluated in f32 as the
    reference's device scalars are."""
    fn = lr if callable(lr) else (lambda _: lr)
    return lambda step: float(np.float32(fn(step)))


class AdamWState(NamedTuple):
    step: int
    m: Any
    v: Any


def adamw(lr: Union[Callable, float], *, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          state_dtype: torch.dtype = torch.float32) -> Optimizer:
    """AdamW with f32 bias correction: ``u = -lr * (m_hat / (sqrt(v_hat) +
    eps) + weight_decay * p)``.  ``lr`` is a float or a function of the
    (1-based) step."""
    lr_fn = _lr_fn(lr)

    def init(params):
        def zeros(p):   # a DTensor param's state takes its placements
            return torch.zeros_like(p, dtype=state_dtype)
        return AdamWState(step=0, m=tree_map(zeros, params),
                          v=tree_map(zeros, params))

    def update(grads, state, params):
        step = state.step + 1
        # the reference computes these as f32 device scalars
        lr_t = lr_fn(step)
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(step))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(step))

        def upd(g, m, v, p):
            g = g.to(state_dtype)
            m_new = b1 * m + (1 - b1) * g
            v_new = b2 * v + (1 - b2) * g * g
            mhat = m_new / bc1
            vhat = v_new / bc2
            u = -lr_t * (mhat / (torch.sqrt(vhat) + eps)
                         + weight_decay * p.to(state_dtype))
            return u, m_new, v_new

        flat = tree_map(upd, grads, state.m, state.v, params)
        updates, m, v = (tree_map(lambda t, i=i: t[i], flat)
                         for i in range(3))
        return updates, AdamWState(step=step, m=m, v=v)

    return Optimizer(init=init, update=update)


class AdafactorState(NamedTuple):
    step: int
    vr: Any   # row second moment (or the full v of a < 2-D leaf)
    vc: Any   # column second moment (zeros(0) for a < 2-D leaf)


def adafactor(lr: Union[Callable, float], *, decay: float = 0.8,
              eps: float = 1e-30, clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern '18), beta1 = 0.

    For >= 2-D leaves (of the stacked layout, :func:`stack_lists`) the
    second moment is a row vector and a column vector over the trailing
    two dims: O(n + m) state instead of O(n m)."""
    lr_fn = _lr_fn(lr)

    def factored(p):
        return p.dim() >= 2

    def init(params):
        stacked = stack_lists(params)

        def vr_init(p):
            shape = p.shape[:-1] if factored(p) else p.shape
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def vc_init(p):
            shape = p.shape[:-2] + p.shape[-1:] if factored(p) else (0,)
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        return AdafactorState(step=0, vr=tree_map(vr_init, stacked),
                              vc=tree_map(vc_init, stacked))

    def update(grads, state, params):
        step = state.step + 1
        # the reference's f32 device scalars
        beta2 = float(np.float32(1) - np.float32(step)
                      ** np.float32(-decay))
        lr_t = lr_fn(step)

        def upd(g, vr, vc, p):
            g = g.float()
            g2 = g * g + eps
            if factored(p):
                vr_new = beta2 * vr + (1 - beta2) * g2.mean(dim=-1)
                vc_new = beta2 * vc + (1 - beta2) * g2.mean(dim=-2)
                r = vr_new / torch.clamp_min(
                    vr_new.mean(dim=-1, keepdim=True), eps)
                prec = r[..., None] * vc_new[..., None, :]
                u = g * torch.rsqrt(torch.clamp_min(prec, eps))
            else:
                vr_new = beta2 * vr + (1 - beta2) * g2
                vc_new = vc
                u = g * torch.rsqrt(torch.clamp_min(vr_new, eps))
            # update clipping by RMS
            rms = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            u = -lr_t * (u + weight_decay * p.float())
            return u, vr_new, vc_new

        flat = tree_map(upd, stack_lists(grads), state.vr, state.vc,
                        stack_lists(params))
        updates, vr, vc = (tree_map(lambda t, i=i: t[i], flat)
                           for i in range(3))
        return (unstack_like(updates, params),
                AdafactorState(step=step, vr=vr, vc=vc))

    return Optimizer(init=init, update=update)
