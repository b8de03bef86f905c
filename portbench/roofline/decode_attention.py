"""Operations and bytes of one call of the paged decode-attention kernel
(``repro_torch/csrc/decode_attention.cu``), frozen from ``chip_smoke.py:
bound_ms`` / ``paged_bound_ms``.

Each input byte is read once and each output byte written once: q and the
output (B, H, hd); K and V only at the ``kv_len[b]`` positions each row
attends to; kv_len (4 bytes a row) and the block-table entries those
positions need (4 bytes each; none for the dense kernel, ``block_size``
None).  4 H hd operations per valid position (q.k and p.v)."""

KERNEL = "decode_attention_kernel"   # the kernel's name in a device trace


def flops_bytes(b: int, h: int, kvh: int, hd: int, kv_lens, item: int = 2,
                block_size: int = 16) -> tuple:
    """(operations, bytes) of one call over rows with ``kv_lens``."""
    n_valid = sum(int(n) for n in kv_lens)
    blocks = (0 if block_size is None
              else sum(-(-int(n) // block_size) for n in kv_lens))
    nbytes = (2 * b * h * hd * item + 2 * n_valid * kvh * hd * item
              + 4 * b + 4 * blocks)
    return 4 * h * hd * n_valid, nbytes
