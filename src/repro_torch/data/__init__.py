"""Datasets (counterpart of ``repro/data``)."""
from repro_torch.data.ecg import make_ecg_dataset  # noqa: F401
