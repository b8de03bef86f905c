"""Learning-rate schedules.

Counterpart of ``repro/optim/schedules.py``.  A schedule takes the
(1-based) step as an int and returns an ``np.float32``, computed in f32
term for term as the reference computes its device scalars.
"""
from __future__ import annotations

import numpy as np

_F32 = np.float32


def constant(value: float):
    def schedule(step):
        return _F32(value)
    return schedule


def cosine_schedule(peak: float, total_steps: int, final_frac: float = 0.1):
    def schedule(step):
        frac = np.clip(_F32(step) / _F32(max(total_steps, 1)), _F32(0),
                       _F32(1))
        # cos rounded from f64, as XLA's f32 cos rounds (numpy's f32 cos
        # misses by an ulp at some angles)
        angle = _F32(np.pi) * frac
        cos = _F32(0.5) * (_F32(1) + _F32(np.cos(np.float64(angle))))
        return _F32(peak) * (_F32(final_frac)
                             + _F32(1 - final_frac) * cos)
    return schedule


def linear_warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_schedule(peak, max(total_steps - warmup_steps, 1), final_frac)

    def schedule(step):
        if step < warmup_steps:
            return _F32(peak) * _F32(step) / _F32(max(warmup_steps, 1))
        return cos(step - warmup_steps)
    return schedule
