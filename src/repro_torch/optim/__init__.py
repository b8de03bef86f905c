"""Optimizers (counterpart of ``repro/optim``)."""
from repro_torch.optim.adamw import adafactor, adamw, apply_updates, clip_by_global_norm  # noqa: F401
from repro_torch.optim.schedules import constant, cosine_schedule, linear_warmup_cosine  # noqa: F401
