"""The one traffic generator: a mix's parameters and a seed -> requests.

A mix file (``portbench/traffic/<name>.json``) gives a closed loop of
``clients`` callers, the engine's ``cache_len`` and prefill batch, and a
distribution each for prompt and output lengths:

* ``{"dist": "lognormal", "median": m, "sigma": s, "min": a, "max": b}``:
  ``m * exp(s * z)``, z standard normal, clipped to [a, b] (the
  log-normal draw of ``repro_torch/serve/loadgen.py: longtail_workload``);
* ``{"dist": "uniform", "min": a, "max": b}``: integers a..b.

Every seed gets the same multiset of lengths: a pool of ``pool`` prompt
lengths and as many output lengths, at the distribution's quantiles
``(i + 0.5) / pool``, which the seed only shuffles (and pairs) and fills
with token ids.  So two seeds do the same amount of work in another order,
and a run's spread is the system's, not the draw's.

Each client's first request starts in steady state: its output length is
cut to a uniform share of the drawn one, so that the first completions
are spread out as they are in a long-running loop.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Any, Dict, Iterator

import numpy as np


@dataclasses.dataclass
class Draw:
    """One request as the traffic draws it: the engine gets only these."""
    index: int               # position in the run's sequence of requests
    prompt: np.ndarray       # (len,) int32 token ids
    max_new: int


def quantiles(dist: Dict[str, Any], n: int) -> np.ndarray:
    """``n`` lengths at the quantiles (i + 0.5) / n of ``dist``."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = int(dist["min"]), int(dist["max"])
    if dist["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(p)) for p in u])
        x = np.rint(float(dist["median"]) * np.exp(float(dist["sigma"]) * z))
    elif dist["dist"] == "uniform":
        x = np.floor(lo + u * (hi - lo + 1))
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(x, lo, hi).astype(np.int64)


def rng_for(seed: int) -> np.random.Generator:
    """A generator for any whole seed (negative or past 64 bits too)."""
    return np.random.default_rng(int(seed) % (1 << 64))


def requests(mix: Dict[str, Any], seed: int, vocab: int) -> Iterator[Draw]:
    """The run's requests in the order the clients send them."""
    rng = rng_for(seed)
    pool = int(mix.get("pool", 4096))
    prompts = rng.permutation(quantiles(mix["prompt"], pool))
    outputs = rng.permutation(quantiles(mix["output"], pool))
    clients = int(mix["clients"])
    i = 0
    while True:
        j = i % pool
        n_new = int(outputs[j])
        if i < clients:
            n_new = max(1, math.ceil(rng.random() * n_new))
        prompt = rng.integers(0, vocab, size=int(prompts[j]),
                              dtype=np.int64).astype(np.int32)
        yield Draw(index=i, prompt=prompt, max_new=n_new)
        i += 1


def check_mix(mix: Dict[str, Any]) -> None:
    """A mix the engine can serve without a refusal or a shed: every
    prompt plus its output fits the cache."""
    if mix.get("loop") != "closed":
        raise ValueError("only closed loops are generated")
    longest = int(mix["prompt"]["max"]) + int(mix["output"]["max"])
    if longest > int(mix["cache_len"]):
        raise ValueError(f"a prompt and its output ({longest} tokens) can "
                         f"exceed cache_len {mix['cache_len']}")
