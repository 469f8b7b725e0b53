"""Synthetic datasets from the paper's experimental section (VI), in numpy.

Random: random-walk series (cumulative sums of N(0,1) steps).  Query
workloads of increasing difficulty: collection series plus Gaussian noise
with sigma in [0.01, 0.1] (the paper's Figure 6a setup).  Seismic-like:
transient bursts over a quiet random-walk baseline.  The same functions
and seeds as `repro.data.synthetic`, so both packages can be fed
identical inputs.
"""

from __future__ import annotations

import numpy as np


def random_walk(n: int, length: int = 256, seed: int = 0,
                dtype=np.float32) -> np.ndarray:
    """(n, length) random-walk series."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.standard_normal((n, length)), axis=1).astype(dtype)


def query_workload(collection: np.ndarray, n_queries: int,
                   noise_sigma: float = 0.0, seed: int = 1,
                   from_collection: bool = True) -> np.ndarray:
    """Random fresh walks (sigma = 0, not part of the dataset) or
    collection series + N(0, sigma) noise (Fig. 6a)."""
    rng = np.random.default_rng(seed)
    L = collection.shape[1]
    if not from_collection or noise_sigma <= 0:
        q = np.cumsum(rng.standard_normal((n_queries, L)), axis=1)
        return q.astype(collection.dtype)
    idx = rng.integers(0, collection.shape[0], size=n_queries)
    q = collection[idx] + rng.normal(0.0, noise_sigma, (n_queries, L))
    return q.astype(collection.dtype)


def seismic_like(n: int, length: int = 256, seed: int = 0,
                 dtype=np.float32) -> np.ndarray:
    """Stand-in for the Seismic dataset (not redistributable): bursts of
    band-limited oscillation over a random-walk baseline — matches the
    qualitative structure (quiet background + transient events)."""
    rng = np.random.default_rng(seed)
    base = np.cumsum(0.1 * rng.standard_normal((n, length)), axis=1)
    t = np.arange(length)
    out = base
    freqs = rng.uniform(0.05, 0.45, size=(n, 1))
    phases = rng.uniform(0, 2 * np.pi, size=(n, 1))
    centers = rng.integers(0, length, size=(n, 1))
    widths = rng.uniform(5, 40, size=(n, 1))
    burst = np.exp(-((t[None, :] - centers) ** 2) / (2 * widths ** 2))
    out = out + burst * np.sin(2 * np.pi * freqs * t[None, :] + phases) \
        * rng.uniform(0.5, 3.0, size=(n, 1))
    return out.astype(dtype)
