"""Operations and bytes of one grouped matmul (``repro_torch/csrc/
moe_gmm.cu``), frozen from ``chip_smoke.py: gmm_flops`` / ``gmm_bound_ms``.

x (E, C, D) and w (E, D, F) read once, the output (E, C, F) written once;
2 E C D F operations (every capacity row is computed).  An MoE layer runs
three: gate and up at (D, F) = (d_model, moe_d_ff), down at (moe_d_ff,
d_model).  ``capacity`` restates the configuration's rule for C: the
tokens' k choices spread over E experts, times the capacity factor,
rounded up to a multiple of 8 and at least 8."""
import math

KERNEL = "gmm_"   # gmm_decode_kernel, gmm_wgmma_kernel, gmm_bf16_kernel


def capacity(n_tokens: int, k: int, n_experts: int, factor: float) -> int:
    cap = math.ceil(n_tokens * k / n_experts * factor)
    return max(8, -(-cap // 8) * 8)


def flops_bytes(e: int, c: int, d: int, f: int, item: int = 2) -> tuple:
    nbytes = (e * c * d + e * d * f + e * c * f) * item
    return 2 * e * c * d * f, nbytes


def layer_least_s(cfg: dict, n_tokens: int, least_s) -> float:
    """Least time of one MoE layer's three launches, each at its own
    bound (``least_s(flops, bytes)``)."""
    e, d, f = cfg["n_experts"], cfg["d_model"], cfg["moe_d_ff"]
    c = capacity(n_tokens, cfg["experts_per_token"], e,
                 cfg["capacity_factor"])
    return 2 * least_s(*flops_bytes(e, c, d, f)) \
        + least_s(*flops_bytes(e, c, f, d))
