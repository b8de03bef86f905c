"""Distributed runtime (counterpart of ``repro/distributed``): logical-axis
sharding rules over a DeviceMesh, and gradient compression."""
from repro_torch.distributed.compression import (  # noqa: F401
    CompressionConfig,
    EFTopK,
    compress_grads,
)
from repro_torch.distributed.sharding import (  # noqa: F401
    axis_rules,
    current_mesh,
    current_rules,
    distribute_params,
    logical_constraint,
    placements_for,
    spec_for,
    tree_shardings,
)
