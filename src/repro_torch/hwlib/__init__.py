"""Parametrizable layer library (counterpart of ``repro/hwlib``): each
layer couples a PyTorch forward with the analytic cost model the NAS
scores candidates by."""
from repro_torch.hwlib.layers import (  # noqa: F401
    LayerCost,
    LayerCostArrays,
    LayerSpec,
    OpCostTable,
    apply_layer,
    batch_layer_costs,
    init_layer,
    layer_cost,
    out_shape,
)
