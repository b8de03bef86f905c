"""AdamW as an (init, update) pair over param trees.

Counterpart of ``repro/optim/adamw.py: adamw, clip_by_global_norm,
apply_updates``, term for term.  A tree is what the reference's candidate
params are: lists and dicts with tensors at the leaves (a tuple is a
leaf); leaves are visited
in the reference's order (dict keys sorted, as ``jax.tree_util`` flattens
them).  Updates are computed out of place, like the reference's.
``adafactor`` waits for the LM-training slice.

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
    return tree_map(lambda g: g * scale, grads), gn


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
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=state_dtype, device=p.device)
        return AdamWState(step=0, m=tree_map(zeros, params),
                          v=tree_map(zeros, params))

    def update(grads, state, params):
        step = state.step + 1
        # the reference computes these as f32 device scalars
        lr_t = float(np.float32(lr_fn(step)))
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
