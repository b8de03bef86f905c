"""Operations and bytes of one causal call of the flash-attention kernel
(``repro_torch/csrc/flash_attention.cu``), frozen from ``chip_smoke.py:
flash_flops`` / ``flash_bound_ms``.

q (B, S, H, hd), k and v (B, S, KVH, hd) read once, the output (B, S, H,
hd) written once; 4 hd operations per (query, key) pair attended and head,
query i seeing keys 0..i."""

KERNEL = "flash_"   # flash_attention_kernel (f32) and flash_wgmma_kernel


def flops_bytes(b: int, s: int, h: int, kvh: int, hd: int,
                item: int = 2) -> tuple:
    pairs = s * (s + 1) // 2
    nbytes = (2 * b * s * h * hd + 2 * b * s * kvh * hd) * item
    return 4 * hd * h * b * pairs, nbytes
