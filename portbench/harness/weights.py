"""Weights drawn by the benchmark, on the device, from the run's seed.

One ``torch.randn`` per kind of matrix over every layer at once (q of all
layers, the experts' gate of all layers, ...), in the type the model is
served in, on a ``torch.Generator`` of the device; each layer's leaf is a
view of its slice.  So set-up draws ~60 GB in about a dozen calls, and
the same seed gives the same weights.  Scales: N(0, 1) embeddings (the
first norm rescales them), N(0, 1 / fan_in) matrices, unit norm scales.

The tree is the layout the port's LM bundle takes (``params["layers"]`` a
list of per-layer dicts, ``(in, out)`` matrices), and the reference reads
the same tensors: nothing here comes from the program.
"""
from __future__ import annotations

from typing import Any, Dict

import torch


def draw_params(cfg: Dict[str, Any], seed: int, device, dtype
                ) -> Dict[str, Any]:
    """Params of the configuration ``cfg`` (a configuration file's model
    keys) for the dense and MoE LM families."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    n, d, v = cfg["n_layers"], cfg["d_model"], cfg["vocab_size"]
    h, kvh = cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or d // h

    def normal(shape, fan_in):
        t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return t.mul_(fan_in ** -0.5) if fan_in else t

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dtype)

    stacked = {
        "q": normal((n, d, h * hd), d), "k": normal((n, d, kvh * hd), d),
        "v": normal((n, d, kvh * hd), d), "o": normal((n, h * hd, d), h * hd),
    }
    if cfg["family"] == "moe":
        e, f = cfg["n_experts"], cfg["moe_d_ff"]
        ffn_key = "moe"
        ffn = {"router": normal((n, d, e), d),
               "gate": normal((n, e, d, f), d), "up": normal((n, e, d, f), d),
               "down": normal((n, e, f, d), f)}
    elif cfg["family"] == "dense":
        f = cfg["d_ff"]
        ffn_key = "mlp"
        ffn = {"gate": normal((n, d, f), d), "up": normal((n, d, f), d),
               "down": normal((n, f, d), f)}
    else:
        raise ValueError(f"no weights for family {cfg['family']!r}")
    norms = ones(n, 2, d)
    layers = [{"attn_norm": {"scale": norms[i, 0]},
               "attn": {k: w[i] for k, w in stacked.items()},
               "mlp_norm": {"scale": norms[i, 1]},
               ffn_key: {k: w[i] for k, w in ffn.items()}}
              for i in range(n)]
    return {"embed": normal((v, d), 0), "layers": layers,
            "final_norm": {"scale": ones(d)}, "unembed": normal((d, v), d)}


def n_params(params: Dict[str, Any]) -> int:
    """Distinct parameters held (each stacked tensor once)."""
    seen, total = set(), 0

    def walk(t):
        nonlocal total
        if isinstance(t, dict):
            for x in t.values():
                walk(x)
        elif isinstance(t, list):
            for x in t:
                walk(x)
        else:
            base = t.untyped_storage().data_ptr()
            if base not in seen:
                seen.add(base)
                total += t.untyped_storage().nbytes() // t.element_size()
    walk(params)
    return total
