"""Reference params -> port params.

The only place where the two packages' layouts are mapped.  For the LM
families ``repro`` stacks every layer's params on a leading ``layers`` axis
(for ``lax.scan``); the port keeps a list of per-layer dicts, and so
for an encoder-decoder's ``enc_layers`` and ``dec_layers``.  An MoE
layer's ``moe`` leaves keep their layout: ``router`` (D, E), ``gate`` and
``up`` (E, D, F), ``down`` (E, F, D), each expert's matrix row-major as the
grouped-matmul kernel reads it.  For the SSM and hybrid families ``repro``
stacks ``groups`` as ``(n_groups, period, ...)`` and ``tail`` as ``(tail,
...)``; the port keeps a list of lists and a list, and ``shared`` once on
both sides.  An ECG candidate is a list of per-layer
dicts on both sides.  Leaf names and ``(in, out)`` matrix layouts are the
same on both sides.

A leaf may be a numpy array (``jax.tree.map(np.asarray, ...)``, bf16 as
``ml_dtypes``) or a CPU tensor (a ``repro`` checkpoint read by the port's
``Checkpointer.restore_tree``, bf16 already a torch dtype).
:func:`train_state_from_jax` maps a whole ``repro`` ``TrainState``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _tensor(a: Any, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to(device, copy=True)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes bf16: reinterpret bits
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _unstack(tree: Any, n: int, dev: torch.device) -> List[Any]:
    """A tree stacked on a leading axis of ``n`` -> a list of ``n`` trees."""
    return [_map(tree, lambda a, i=i: _tensor(a[i], dev)) for i in range(n)]


def _leading(tree: Any) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def params_from_jax(tree: Dict[str, Any], device: DeviceLike = None
                    ) -> Dict[str, Any]:
    """``tree`` is the reference's ``init_lm``, ``init_hybrid`` or
    ``init_encdec`` params with numpy leaves (``jax.tree.map(np.asarray,
    params)``).  Returns the port's params on ``device``, each leaf in its
    source dtype."""
    dev = resolve_device(device)
    if "enc_layers" in tree:                  # encoder-decoder
        out = {k: _unstack(tree[k], _leading(tree[k]), dev)
               for k in ("enc_layers", "dec_layers")}
        out["embed"] = _tensor(tree["embed"], dev)
        for k in ("enc_norm", "final_norm"):
            out[k] = _map(tree[k], lambda a: _tensor(a, dev))
        return out
    if "layers" not in tree:                  # SSM / hybrid families
        out = {k: _tensor(tree[k], dev) for k in ("embed", "unembed")}
        out["final_norm"] = _map(tree["final_norm"],
                                 lambda a: _tensor(a, dev))
        if "groups" in tree:
            groups = tree["groups"]
            per_group = [_map(groups, lambda a, g=g: a[g])
                         for g in range(_leading(groups))]
            out["groups"] = [_unstack(t, _leading(t), dev)
                             for t in per_group]
            out["shared"] = _map(tree["shared"], lambda a: _tensor(a, dev))
        if "tail" in tree:
            out["tail"] = _unstack(tree["tail"], _leading(tree["tail"]), dev)
        return out
    layers = tree["layers"]
    out: Dict[str, Any] = {
        "embed": _tensor(tree["embed"], dev),
        "layers": _unstack(layers, _leading(layers), dev),
        "final_norm": _map(tree["final_norm"], lambda a: _tensor(a, dev)),
    }
    if "unembed" in tree:
        out["unembed"] = _tensor(tree["unembed"], dev)
    return out


def candidate_params_from_jax(params_list: Sequence[Dict[str, Any]],
                              device: DeviceLike = None
                              ) -> List[Dict[str, torch.Tensor]]:
    """``params_list`` is a reference candidate's params (``init_candidate``
    or a trained tree) with numpy leaves.  Returns the port's list of
    per-layer dicts on ``device``, each leaf in its source dtype."""
    dev = resolve_device(device)
    return [{k: _tensor(v, dev) for k, v in p.items()} for p in params_list]


def train_state_from_jax(state: Any, device: DeviceLike = None):
    """``state`` is a ``repro`` ``TrainState`` of an LM, SSM or hybrid
    model (as a NamedTuple with numpy leaves, or as the nested dicts of
    ``Checkpointer.restore_tree`` over a ``repro`` checkpoint).  Returns
    the port's ``TrainState`` on ``device``: params and AdamW's ``m`` and
    ``v`` in the port's layout (:func:`params_from_jax`); Adafactor's
    ``vr`` and ``vc`` keep the reference's stacked layout, which the
    port's Adafactor keeps too."""
    from repro_torch.optim.adamw import AdafactorState, AdamWState
    from repro_torch.training.step import TrainState

    def get(tree, key):
        return tree[key] if isinstance(tree, Mapping) else getattr(tree, key)

    dev = resolve_device(device)
    opt = get(state, "opt_state")
    opt_step = int(np.asarray(get(opt, "step")))
    if (isinstance(opt, Mapping) and "m" in opt) or hasattr(opt, "m"):
        opt_state = AdamWState(step=opt_step,
                               m=params_from_jax(get(opt, "m"), dev),
                               v=params_from_jax(get(opt, "v"), dev))
    else:
        opt_state = AdafactorState(
            step=opt_step,
            vr=_map(get(opt, "vr"), lambda a: _tensor(a, dev)),
            vc=_map(get(opt, "vc"), lambda a: _tensor(a, dev)))
    return TrainState(step=int(np.asarray(get(state, "step"))),
                      params=params_from_jax(get(state, "params"), dev),
                      opt_state=opt_state)
