"""Distributed runtime (counterpart of ``repro/distributed``): gradient
compression.  Sharding rules wait for the TPU-pod tooling."""
from repro_torch.distributed.compression import (  # noqa: F401
    CompressionConfig,
    EFTopK,
    compress_grads,
)
