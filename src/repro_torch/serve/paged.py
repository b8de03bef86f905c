"""Block-pool accounting for the paged KV cache (DESIGN.md §15).

A copy of ``repro/serve/paged.py`` (numpy only).  The sentinel table
entries are clamped and masked by the paged decode-attention kernel; the
port's prefill splice and decode write select them away (torch has no
``mode="drop"``).

Host-side allocator: the device holds the K/V pools and the int32 block
tables; this module owns *which* pool block belongs to *which* serving
slot.  All policies are deterministic — the free list is LIFO and every
operation is driven by the engine's virtual clock — so paged runs are
exactly reproducible.

Invariants:
  * a block belongs to at most one slot at any time;
  * ``table_array()`` rows list a slot's blocks in logical order, padded
    with the sentinel ``n_blocks`` (dropped by ``mode="drop"`` scatters
    and clamped+masked by the kernels);
  * freeing is all-or-nothing per slot (sequences never shrink).
"""
from __future__ import annotations

from typing import List

import numpy as np

__all__ = ["BlockPool", "blocks_for"]


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` cache positions (>= 1)."""
    return -(-max(int(n_tokens), 1) // block_size)


class BlockPool:
    """Fixed-size block allocator with per-slot block tables.

    ``n_blocks`` blocks of ``block_size`` tokens each, shared by
    ``slots`` serving slots; a slot holds at most ``max_blocks_per_slot``
    (= cache_len / block_size) blocks.  ``alloc``/``ensure`` fail
    explicitly (return ``False``) on exhaustion — the engine turns that
    into head-of-line admission blocking or an OOM shed, never a silent
    drop.
    """

    def __init__(self, n_blocks: int, block_size: int, slots: int,
                 max_blocks_per_slot: int):
        if n_blocks < 1:
            raise ValueError("n_blocks must be >= 1")
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self.slots = int(slots)
        self.max_blocks_per_slot = int(max_blocks_per_slot)
        self.reset()

    def reset(self) -> None:
        # LIFO free list; pop() hands out block 0 first and reuses the
        # most recently freed blocks — deterministic and cache-friendly.
        self._free = list(range(self.n_blocks - 1, -1, -1))
        self._held: List[List[int]] = [[] for _ in range(self.slots)]
        self.peak_used = 0
        self.allocs = 0
        self.frees = 0

    # ------------------------------------------------------------ queries
    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used(self) -> int:
        return self.n_blocks - len(self._free)

    def blocks_for(self, n_tokens: int) -> int:
        return blocks_for(n_tokens, self.block_size)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def held(self, slot: int) -> int:
        """Number of blocks currently held by ``slot``."""
        return len(self._held[slot])

    # -------------------------------------------------------- alloc / free
    def alloc(self, slot: int, n: int) -> bool:
        """Grant ``n`` more blocks to ``slot``; all-or-nothing."""
        if n > len(self._free):
            return False
        if len(self._held[slot]) + n > self.max_blocks_per_slot:
            return False
        for _ in range(n):
            self._held[slot].append(self._free.pop())
        self.allocs += n
        self.peak_used = max(self.peak_used, self.used)
        return True

    def ensure(self, slot: int, pos: int) -> bool:
        """Grow ``slot``'s table until it covers token position ``pos``."""
        need = pos // self.block_size + 1 - len(self._held[slot])
        if need <= 0:
            return True
        return self.alloc(slot, need)

    def free_slot(self, slot: int) -> int:
        """Return all of ``slot``'s blocks to the pool; returns the count."""
        blks = self._held[slot]
        n = len(blks)
        self.frees += n
        self._free.extend(reversed(blks))
        self._held[slot] = []
        return n

    # ------------------------------------------------------------- tables
    def table_array(self) -> np.ndarray:
        """(slots, max_blocks_per_slot) int32; sentinel = n_blocks."""
        t = np.full((self.slots, self.max_blocks_per_slot), self.n_blocks,
                    np.int32)
        for s, blks in enumerate(self._held):
            if blks:
                t[s, :len(blks)] = blks
        return t

    def slot_blocks(self, slot: int) -> List[int]:
        return list(self._held[slot])
