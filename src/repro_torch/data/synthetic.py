"""Synthetic datasets from the paper's experimental section (VI), in numpy.

Random: random-walk series (cumulative sums of N(0,1) steps).  Query
workloads of increasing difficulty: collection series plus Gaussian noise
with sigma in [0.01, 0.1] (the paper's Figure 6a setup).  The same
functions and seeds as `repro.data.synthetic`, so both packages can be
fed identical inputs.
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
