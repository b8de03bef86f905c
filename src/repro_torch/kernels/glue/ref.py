"""The plain version of the decode step's fused RoPE and pool write
(``csrc/glue.cu``: ``glue_rope`` with pools): ``models/common.py``'s
RoPE and the two ``index_put_`` it replaces.  The other glue ops' plain
versions are the models' own (``common.rmsnorm``, ``common.rope_at``,
``F.silu(g) * u``)."""
from __future__ import annotations

import torch

from repro_torch.models.common import rope_at


def rope_write_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_lens: torch.Tensor, inv_freq: torch.Tensor,
                   k_pool: torch.Tensor, v_pool: torch.Tensor,
                   blk: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """One decode step's q and k (B, 1, heads, hd) rotated at ``kv_lens``
    (B,) less one, the step's own positions; row b's rotated k and its v
    written to the pools (P, BS, KVH, hd) at block ``blk[b]``, offset
    ``off[b]``, where ``blk[b] >= 0``.  Returns the rotated q."""
    positions = (kv_lens - 1)[:, None]
    q_rot, k_rot = rope_at(q, positions, inv_freq), \
        rope_at(k, positions, inv_freq)
    rows = blk >= 0
    k_pool.index_put_((blk[rows], off[rows]), k_rot[rows, 0])
    v_pool.index_put_((blk[rows], off[rows]), v[rows, 0])
    return q_rot
