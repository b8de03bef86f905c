"""Synthetic LM token pipeline: deterministic, host-sharded, restartable.

A copy of ``repro/data/lm.py`` (numpy only), kept so the port imports
nothing of ``repro``: the same (seed, step, host) gives the same batch
bit for bit in both packages.  The training loop turns the int32 arrays
into int64 tensors on its device.

A Markov-ish token stream with Zipf unigram statistics and local structure
(so small models have signal to fit).  Each host generates exactly its data
shard from (seed, step, host_index) — no cross-host IO, and restarting at
step N regenerates the identical batch (checkpoint/restart safe).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1


def _batch_rng(cfg: LMDataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_index]))


def make_batch(cfg: LMDataConfig, step: int) -> Dict[str, np.ndarray]:
    """tokens/labels: (local_batch, seq_len) int32. labels = next token."""
    assert cfg.global_batch % cfg.host_count == 0
    local = cfg.global_batch // cfg.host_count
    rng = _batch_rng(cfg, step)
    v = cfg.vocab_size
    # Zipf-ish unigrams over a capped alphabet for fast sampling
    alpha = min(v, 4096)
    ranks = np.arange(1, alpha + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    base = rng.choice(alpha, size=(local, cfg.seq_len + 1), p=probs)
    # local structure: with p=0.3 copy the token from 2 positions back
    copy_mask = rng.random((local, cfg.seq_len + 1)) < 0.3
    base[:, 2:] = np.where(copy_mask[:, 2:], base[:, :-2], base[:, 2:])
    data = (base % v).astype(np.int32)
    return {"tokens": data[:, :-1], "labels": data[:, 1:]}


def data_iterator(cfg: LMDataConfig, start_step: int = 0
                  ) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield make_batch(cfg, step)
        step += 1
