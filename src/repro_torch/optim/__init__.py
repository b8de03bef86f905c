"""Optimizers (counterpart of ``repro/optim``)."""
from repro_torch.optim.adamw import adamw, apply_updates, clip_by_global_norm  # noqa: F401
