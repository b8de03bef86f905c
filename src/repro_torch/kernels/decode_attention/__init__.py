"""Single-token GQA decode attention over a dense per-row KV cache or a
paged block pool."""
from repro_torch.kernels.decode_attention.ops import (
    decode_attention,
    paged_decode_attention,
)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref,
    gather_paged_kv,
    paged_decode_attention_ref,
)

__all__ = ["decode_attention", "decode_attention_ref", "gather_paged_kv",
           "paged_decode_attention", "paged_decode_attention_ref"]
