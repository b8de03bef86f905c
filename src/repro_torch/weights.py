"""Reference params -> port params.

The only place where the two packages' layouts are mapped.  For the LM
family ``repro`` stacks every layer's params on a leading ``layers`` axis
(for ``lax.scan``); the port keeps a list of per-layer dicts.  For the SSM
and hybrid families it stacks ``groups`` as ``(n_groups, period, ...)`` and
``tail`` as ``(tail, ...)``; the port keeps a list of lists and a list, and
``shared`` once on both sides.  An ECG candidate is a list of per-layer
dicts on both sides.  Leaf names and ``(in, out)`` matrix layouts are the
same on both sides.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _tensor(a: Any, device: torch.device) -> torch.Tensor:
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
    return [_map(tree, lambda a, i=i: _tensor(np.asarray(a)[i], dev))
            for i in range(n)]


def _leading(tree: Any) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.asarray(tree).shape[0]


def params_from_jax(tree: Dict[str, Any], device: DeviceLike = None
                    ) -> Dict[str, Any]:
    """``tree`` is the reference's ``init_lm`` or ``init_hybrid`` params
    with numpy leaves (``jax.tree.map(np.asarray, params)``).  Returns the
    port's params on ``device``, each leaf in its source dtype."""
    dev = resolve_device(device)
    if "layers" not in tree:                  # SSM / hybrid families
        out = {k: _tensor(tree[k], dev) for k in ("embed", "unembed")}
        out["final_norm"] = _map(tree["final_norm"],
                                 lambda a: _tensor(a, dev))
        if "groups" in tree:
            groups = tree["groups"]
            per_group = [_map(groups, lambda a, g=g: np.asarray(a)[g])
                         for g in range(_leading(groups))]
            out["groups"] = [_unstack(t, _leading(t), dev)
                             for t in per_group]
            out["shared"] = _map(tree["shared"], lambda a: _tensor(a, dev))
        if "tail" in tree:
            out["tail"] = _unstack(tree["tail"], _leading(tree["tail"]), dev)
        return out
    layers = tree["layers"]
    if "moe" in layers:
        raise NotImplementedError("MoE params are not yet ported")
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
