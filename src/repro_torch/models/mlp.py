"""Feed-forward blocks: SwiGLU (llama-style) and GELU (whisper-style).

Counterpart of ``repro/models/mlp.py``."""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init


def init_mlp(gen: torch.Generator, cfg: ModelConfig, d_ff: int = 0
             ) -> Dict[str, torch.Tensor]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {
            "gate": dense_init(gen, (d, f), d),
            "up": dense_init(gen, (d, f), d),
            "down": dense_init(gen, (f, d), f),
        }
    return {
        "up": dense_init(gen, (d, f), d),
        "up_b": torch.zeros((f,), dtype=torch.float32, device=gen.device),
        "down": dense_init(gen, (f, d), f),
        "down_b": torch.zeros((d,), dtype=torch.float32, device=gen.device),
    }


def mlp_specs(cfg: ModelConfig, prefix: Tuple = ()) -> Dict[str, Tuple]:
    """Logical axis names of each MLP param, as ``repro``'s."""
    if cfg.act == "swiglu":
        return {
            "gate": prefix + ("embed", "mlp"),
            "up": prefix + ("embed", "mlp"),
            "down": prefix + ("mlp", "embed"),
        }
    return {
        "up": prefix + ("embed", "mlp"),
        "up_b": prefix + ("mlp",),
        "down": prefix + ("mlp", "embed"),
        "down_b": prefix + (None,),
    }


def mlp_block(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    if cfg.act == "swiglu":
        h = F.silu(x @ p["gate"].to(x.dtype)) * (x @ p["up"].to(x.dtype))
        return h @ p["down"].to(x.dtype)
    h = F.gelu(x @ p["up"].to(x.dtype) + p["up_b"].to(x.dtype),
               approximate="tanh")
    return h @ p["down"].to(x.dtype) + p["down_b"].to(x.dtype)
