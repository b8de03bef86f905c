"""Prefill admission buckets (DESIGN.md §12).

The trainer's signature-bucket idiom (core/trainer_batch.py) applied to
serving: every distinct prefill shape ``(batch, length)`` is a compiled
executable, so admission quantizes both axes to keep the compile population
small and the batches dense.

* **length**: prompts are right-padded up to the next multiple of
  ``pad_to`` (granularity 1 = exact-length grouping — required for SSM
  families whose states fold every input token, and the bit-parity
  reference mode).  One bucket per padded length per admission round.
* **batch**: each bucket's row count is padded up to the next power of two
  (capped at ``max_batch``); pad rows carry dummy tokens and are scattered
  nowhere (their slot index is out of range and the cache splice drops
  out-of-bounds rows).

With ``pad_to=8`` and ``max_batch=8`` a workload of arbitrary prompt
lengths ≤ 32 compiles at most ``4 lengths × 4 batch sizes`` prefill
executables, ever.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


def pad_length(n: int, pad_to: int) -> int:
    """Smallest multiple of ``pad_to`` that is >= n."""
    return ((n + pad_to - 1) // pad_to) * pad_to


def pad_batch(n: int, max_batch: int) -> int:
    """Smallest power of two >= n, capped at ``max_batch``."""
    p = 1
    while p < n:
        p *= 2
    return min(p, max_batch)


@dataclasses.dataclass
class PrefillBucket:
    """One prefill dispatch: ``tokens (B_pad, L)`` right-padded rows, true
    ``lens``, and the destination slot per real row (pad rows get the
    out-of-range slot index ``n_slots`` and are dropped by the splice)."""

    tokens: np.ndarray      # (B_pad, L) int32
    lens: np.ndarray        # (B_pad,) int32 (pad rows: 1)
    slot_idx: np.ndarray    # (B_pad,) int32 (pad rows: n_slots → dropped)
    rows: List[int]         # indices into the admitted request list


def build_buckets(
    prompts: Sequence[np.ndarray],
    slots: Sequence[int],
    n_slots: int,
    *,
    pad_to: int = 1,
    max_batch: int = 8,
) -> List[PrefillBucket]:
    """Group admitted prompts by padded length into prefill dispatches.

    ``prompts[i]`` goes to slot ``slots[i]``.  Groups larger than
    ``max_batch`` split into chains of ``max_batch``-row dispatches.
    """
    by_len: Dict[int, List[int]] = {}
    for i, p in enumerate(prompts):
        by_len.setdefault(pad_length(len(p), pad_to), []).append(i)

    buckets = []
    for lpad, rows in sorted(by_len.items()):
        for lo in range(0, len(rows), max_batch):
            chunk = rows[lo: lo + max_batch]
            bp = pad_batch(len(chunk), max_batch)
            tokens = np.zeros((bp, lpad), np.int32)
            lens = np.ones((bp,), np.int32)
            slot_idx = np.full((bp,), n_slots, np.int32)
            for r, i in enumerate(chunk):
                tokens[r, : len(prompts[i])] = prompts[i]
                lens[r] = len(prompts[i])
                slot_idx[r] = slots[i]
            buckets.append(PrefillBucket(tokens=tokens, lens=lens,
                                         slot_idx=slot_idx, rows=chunk))
    return buckets
