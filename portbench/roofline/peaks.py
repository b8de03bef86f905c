"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity), copied from ``repro_torch/launch/roofline.py:
H100_SXM``.  They assume the card's full 700 W; a run prints the card's
``power.limit`` beside every share taken against them."""

PEAK_FLOPS = {"bfloat16": 989.4e12, "float16": 989.4e12}
HBM_BYTES_PER_S = 3.35e12


def least_s(flops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the HBM rate."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
