"""LEMONADE-style Bayesian two-step selection (paper §III-A, via Elsken'18).

A copy of ``repro/core/selection.py`` (numpy only), imports repointed to
the port.

"For the selection strategy, we use a similar, bayesian-based method as [13],
which explores the Pareto Frontier of DNN candidates efficiently in a
two-step procedure, preselecting candidates based on computationally
inexpensive objectives first."

Mechanics: a kernel-density estimate (KDE) is fit over the *cheap* objective
values of the current population.  (1) Parents are sampled with probability
proportional to 1/density — favoring sparse regions of the cheap-objective
space; (2) generated children are preselected for *expensive* evaluation with
the same inverse-density weighting, so training budget flows to candidates
that extend the frontier rather than duplicate it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.pareto import normalize


# Cap on the transient (chunk, n) kernel matrix inside GaussianKDE.density.
# The naive (m, n, d) broadcast is tens of GB at population 10k+; densities
# are instead computed chunk-by-chunk over the query axis with a GEMM for
# the pairwise distances, so memory stays bounded at any population size.
_DENSITY_CHUNK_BYTES = 64 * 1024 * 1024


class GaussianKDE:
    """Minimal Gaussian KDE with Scott's-rule bandwidth (no scipy on box)."""

    def __init__(self, data: np.ndarray):
        data = np.atleast_2d(np.asarray(data, dtype=np.float64))
        if data.ndim != 2:
            raise ValueError("data must be (n, d)")
        self.data = data
        n, d = data.shape
        sigma = data.std(axis=0)
        sigma = np.where(sigma > 1e-9, sigma, 1.0)
        self.h = sigma * max(n, 2) ** (-1.0 / (d + 4))  # Scott's rule
        self._zd = data / self.h            # bandwidth-standardized data
        self._zd_sq = np.einsum("nd,nd->n", self._zd, self._zd)

    def density(self, x: np.ndarray, chunk: Optional[int] = None
                ) -> np.ndarray:
        """Density at each query row.

        Pairwise squared distances come from the GEMM identity
        ``|zx - zd|^2 = |zx|^2 + |zd|^2 - 2 zx.zd^T`` (clipped at 0 against
        cancellation), and queries are processed in chunks sized to keep the
        ``(chunk, n)`` kernel matrix under ``_DENSITY_CHUNK_BYTES`` (pass
        ``chunk`` to override) — memory-bounded at population 10k+.
        """
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        n, d = self.data.shape
        if chunk is None:
            chunk = max(1, _DENSITY_CHUNK_BYTES // (n * 8))
        norm = np.prod(self.h) * (2 * np.pi) ** (d / 2)
        out = np.empty(len(x), dtype=np.float64)
        for s in range(0, len(x), chunk):
            zx = x[s:s + chunk] / self.h
            d2 = (np.einsum("md,md->m", zx, zx)[:, None] + self._zd_sq[None, :]
                  - 2.0 * (zx @ self._zd.T))
            out[s:s + chunk] = np.exp(-0.5 * np.maximum(d2, 0.0)).sum(axis=1)
        return out / (n * norm) + 1e-300


def inverse_density_weights(pop_cheap: np.ndarray,
                            query_cheap: Optional[np.ndarray] = None,
                            cols: Optional[np.ndarray] = None
                            ) -> np.ndarray:
    """Normalized sampling weights ∝ 1/KDE-density in cheap-objective space.

    ``cols`` restricts the KDE to an objective-column subset (a
    goal-conditioned view of the schema-shaped cheap matrix): density — and
    therefore exploration pressure — is then measured only along the
    deployment goal's objectives.  ``None`` keeps the full space.
    """
    if cols is not None:
        pop_cheap = pop_cheap[:, cols]
        if query_cheap is not None:
            query_cheap = query_cheap[:, cols]
    pop_n = normalize(pop_cheap)
    kde = GaussianKDE(pop_n)
    if query_cheap is None:
        q = pop_n
    else:
        # normalize queries with the population's scaling
        lo = pop_cheap.min(axis=0)
        hi = pop_cheap.max(axis=0)
        span = np.where(hi - lo > 1e-12, hi - lo, 1.0)
        q = (query_cheap - lo) / span
    w = 1.0 / kde.density(q)
    w = np.where(np.isfinite(w), w, 0.0)
    s = w.sum()
    if s <= 0:
        return np.full(len(q), 1.0 / len(q))
    return w / s


def sample_parents(rng: np.random.Generator, pop_cheap: np.ndarray,
                   n: int, cols: Optional[np.ndarray] = None) -> np.ndarray:
    """Indices of `n` parents sampled inverse-density (with replacement).
    ``cols`` = goal-conditioned objective subset (None = all columns)."""
    w = inverse_density_weights(pop_cheap, cols=cols)
    return rng.choice(len(pop_cheap), size=n, replace=True, p=w)


def preselect_children(rng: np.random.Generator, pop_cheap: np.ndarray,
                       child_cheap: np.ndarray, n_accept: int,
                       cols: Optional[np.ndarray] = None) -> np.ndarray:
    """Step 2: pick children for expensive evaluation, inverse-density
    weighted against the *current population's* cheap-objective KDE.
    ``cols`` = goal-conditioned objective subset (None = all columns)."""
    if len(child_cheap) <= n_accept:
        return np.arange(len(child_cheap))
    w = inverse_density_weights(pop_cheap, child_cheap, cols=cols)
    if not np.all(np.isfinite(w)) or w.sum() <= 0:
        return rng.choice(len(child_cheap), size=n_accept, replace=False)
    return rng.choice(len(child_cheap), size=n_accept, replace=False, p=w)
