"""Open-loop load generation + latency accounting (DESIGN.md §12, §14).

A copy of ``repro/serve/loadgen.py`` (numpy only): for one seed both
packages draw the same workloads.

Open loop means arrivals follow their own clock (a Poisson process) and do
NOT wait for the server — the honest way to measure a serving system,
because a slow server accumulates queueing delay into the reported
latencies instead of silently throttling the load (closed-loop
coordinated omission).

Three arrival shapes, all seeded-deterministic:

* :func:`poisson_workload` — exponential inter-arrivals, the memoryless
  steady-state shape;
* :func:`gamma_workload` — gamma inter-arrivals with a chosen coefficient
  of variation: ``cv > 1`` produces heavy-tailed bursts (clumps of
  near-simultaneous arrivals separated by long gaps), the overload shape
  the replica router's load shedding is benchmarked under;
* :func:`onoff_workload` — on/off bursts: Poisson arrivals during on
  windows, silence during off windows — the diurnal/batch-upstream shape.
* :func:`longtail_workload` — Poisson arrivals with *log-normal* prompt
  lengths: most prompts short, a heavy tail near ``max_prompt`` — the
  length mix where paged KV allocation beats worst-case dense slots
  (DESIGN.md §15).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serve.engine import ServeRequest


def _requests_at(arrivals: np.ndarray, rng: np.random.Generator, *,
                 vocab_size: int, prompt_lens: Sequence[int],
                 out_lens: Sequence[int]) -> List[ServeRequest]:
    """Mixed prompt/output-length requests at the given arrival stamps.
    Draw order (one prompt-length choice, one prompt, one output choice
    per request) is part of the determinism contract."""
    reqs = []
    for i in range(len(arrivals)):
        plen = int(rng.choice(prompt_lens))
        reqs.append(ServeRequest(
            rid=i,
            prompt=rng.integers(0, vocab_size, plen).astype(np.int32),
            max_new=int(rng.choice(out_lens)),
            arrival_s=float(arrivals[i]),
        ))
    return reqs


def poisson_workload(
    n_requests: int,
    *,
    vocab_size: int,
    rate_per_s: float,
    prompt_lens: Sequence[int] = (4, 8, 12, 16, 24),
    out_lens: Sequence[int] = (4, 8, 12, 16, 24),
    seed: int = 0,
) -> List[ServeRequest]:
    """Mixed prompt/output-length requests with Poisson (exponential
    inter-arrival) timestamps.  ``rate_per_s=0`` degenerates to a burst
    (every request arrives at t=0) — the pure-throughput workload."""
    rng = np.random.default_rng(seed)
    if rate_per_s > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / rate_per_s, n_requests))
    else:
        arrivals = np.zeros(n_requests)
    return _requests_at(arrivals, rng, vocab_size=vocab_size,
                        prompt_lens=prompt_lens, out_lens=out_lens)


def gamma_workload(
    n_requests: int,
    *,
    vocab_size: int,
    rate_per_s: float,
    cv: float = 3.0,
    prompt_lens: Sequence[int] = (4, 8, 12, 16, 24),
    out_lens: Sequence[int] = (4, 8, 12, 16, 24),
    seed: int = 0,
) -> List[ServeRequest]:
    """Heavy-tailed arrivals: gamma inter-arrival times with mean
    ``1/rate_per_s`` and coefficient of variation ``cv`` (shape
    ``1/cv**2``, scale ``cv**2/rate``).  ``cv=1`` recovers the
    exponential; ``cv > 1`` front-loads probability mass near zero with a
    long tail — clumps of back-to-back arrivals separated by idle gaps,
    the shape that drives a bounded admission queue into explicit
    shedding."""
    if rate_per_s <= 0:
        raise ValueError("gamma_workload needs rate_per_s > 0 "
                         "(use poisson_workload(rate_per_s=0) for a burst)")
    if cv <= 0:
        raise ValueError("coefficient of variation must be positive")
    rng = np.random.default_rng(seed)
    shape = 1.0 / (cv * cv)
    scale = (cv * cv) / rate_per_s
    arrivals = np.cumsum(rng.gamma(shape, scale, n_requests))
    return _requests_at(arrivals, rng, vocab_size=vocab_size,
                        prompt_lens=prompt_lens, out_lens=out_lens)


def onoff_workload(
    n_requests: int,
    *,
    vocab_size: int,
    rate_per_s: float,
    on_s: float,
    off_s: float,
    prompt_lens: Sequence[int] = (4, 8, 12, 16, 24),
    out_lens: Sequence[int] = (4, 8, 12, 16, 24),
    seed: int = 0,
) -> List[ServeRequest]:
    """On/off burst arrivals: Poisson at ``rate_per_s`` during ``on_s``-
    second windows, silence for ``off_s`` between them.  Implemented by
    drawing plain Poisson arrivals on a *busy-time* axis and folding that
    axis onto the wall clock, skipping the off windows — so every arrival
    lands strictly inside an on window and the within-burst statistics
    stay exactly Poisson."""
    if rate_per_s <= 0 or on_s <= 0 or off_s < 0:
        raise ValueError("onoff_workload needs rate_per_s > 0, on_s > 0, "
                         "off_s >= 0")
    rng = np.random.default_rng(seed)
    busy = np.cumsum(rng.exponential(1.0 / rate_per_s, n_requests))
    period = on_s + off_s
    arrivals = (busy // on_s) * period + (busy % on_s)
    return _requests_at(arrivals, rng, vocab_size=vocab_size,
                        prompt_lens=prompt_lens, out_lens=out_lens)


def longtail_workload(
    n_requests: int,
    *,
    vocab_size: int,
    rate_per_s: float,
    median_prompt: int = 6,
    sigma: float = 0.8,
    max_prompt: int = 64,
    out_lens: Sequence[int] = (4, 8, 12, 16),
    seed: int = 0,
) -> List[ServeRequest]:
    """Long-tail prompt-length mix: Poisson arrivals (``rate_per_s=0`` =
    burst) with prompt lengths drawn log-normally — median
    ``median_prompt``, log-space spread ``sigma``, clipped to
    ``[1, max_prompt]``.  Most prompts are a handful of tokens while a
    few approach ``max_prompt``; dense slots must reserve ``max_prompt``
    positions for everyone, a paged pool only pays for what each request
    actually holds.  Draw order (arrivals, then per-request prompt
    length / prompt / output choice) is part of the determinism
    contract."""
    if median_prompt < 1 or max_prompt < median_prompt:
        raise ValueError("need 1 <= median_prompt <= max_prompt")
    rng = np.random.default_rng(seed)
    if rate_per_s > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / rate_per_s, n_requests))
    else:
        arrivals = np.zeros(n_requests)
    reqs = []
    for i in range(n_requests):
        plen = int(np.clip(round(rng.lognormal(np.log(median_prompt),
                                               sigma)), 1, max_prompt))
        reqs.append(ServeRequest(
            rid=i,
            prompt=rng.integers(0, vocab_size, plen).astype(np.int32),
            max_new=int(rng.choice(out_lens)),
            arrival_s=float(arrivals[i]),
        ))
    return reqs


def latency_stats(finished: Sequence[ServeRequest],
                  makespan_s: Optional[float] = None) -> Dict[str, float]:
    """p50/p99 end-to-end latency + time-to-first-token and throughput."""
    lat = np.array([r.latency_s for r in finished])
    ttft = np.array([r.ttft_s for r in finished])
    tokens = int(sum(len(r.out) for r in finished))
    span = makespan_s if makespan_s is not None else (
        max(r.t_done for r in finished) if len(finished) else 0.0)
    return {
        "requests": float(len(finished)),
        "tokens": float(tokens),
        "tok_per_s": tokens / span if span > 0 else 0.0,
        "p50_latency_s": float(np.percentile(lat, 50)) if len(lat) else 0.0,
        "p99_latency_s": float(np.percentile(lat, 99)) if len(lat) else 0.0,
        "p50_ttft_s": float(np.percentile(ttft, 50)) if len(ttft) else 0.0,
        "p99_ttft_s": float(np.percentile(ttft, 99)) if len(ttft) else 0.0,
        "makespan_s": float(span),
    }
