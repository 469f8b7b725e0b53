"""DTW similarity support (paper Section II: "our techniques are general
enough to work for other popular similarity measures, such as DTW").

The port's counterpart of `repro.core.dtw`: exact 1-NN under Dynamic
Time Warping with a Sakoe-Chiba band of radius r, with repro's
semantics and defaults.

  * `lb_keogh` — the envelope lower bound [Keogh'02]: any candidate's
    pointwise excursion outside the query's rolling min/max envelope
    lower-bounds its DTW distance.
  * `dtw_band` — banded DTW: O(L (2r+1)) cells.
  * `search_dtw` — prune then refine: for each query, LB_Keogh against
    every series, a stable ascending sort of the bounds (ties to the lower
    id), then candidates refined `round_k` at a time in that order against
    a best-so-far, stopping when the next round's first bound is >= it —
    exact by the lower-bound property.
  * `search_dtw_bruteforce` — banded DTW against every series.

On the card LB_Keogh, the refinement and the scan are the kernels of
`kernels/dtw.py` (`csrc/dtw.cu`); the sort is `torch.sort`, as repro's
is `jnp.argsort` outside any kernel.  Queries go in groups of
`GROUP` (32): a group's bounds (32 N float32) and sort order (32 N
int64) are what the search holds beside the collection, 1.5 GiB at
N = 2^22.  On the CPU the kernels' plain versions run.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import dtw as kdtw
from repro_torch.kernels.ref import BIG, dtw_envelope

from . import isax

GROUP = 32                     # queries a search takes at once

__all__ = ["BIG", "GROUP", "dtw_band", "dtw_ref", "envelope", "lb_keogh",
           "search_dtw", "search_dtw_bruteforce"]


def envelope(q: torch.Tensor, r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rolling min/max of q within +-r (the Sakoe-Chiba envelope).
    q: (..., L) -> (lower, upper) each (..., L)."""
    return dtw_envelope(q, r)


def lb_keogh(q: torch.Tensor, xs: torch.Tensor, r: int) -> torch.Tensor:
    """Squared LB_Keogh(q, x) <= DTW^2(q, x) for band radius r.
    q: (L,); xs: (N, L) -> (N,), float32 on xs's device."""
    q = q.to(device=xs.device, dtype=torch.float32).reshape(1, -1)
    return kdtw.lb_keogh(q.contiguous(), xs.float().contiguous(), r=r)[0]


def dtw_band(q: torch.Tensor, x: torch.Tensor, r: int) -> torch.Tensor:
    """Squared banded-DTW distance.  q, x: (L,) -> a 0-d float32 tensor
    on x's device."""
    q = q.to(device=x.device, dtype=torch.float32).reshape(1, -1)
    d2, _ = kdtw.dtw_scan(q.contiguous(),
                          x.float().reshape(1, -1).contiguous(), r=r)
    return d2[0]


def dtw_ref(q, x, r: int) -> float:
    """O(L^2) numpy oracle for tests."""
    L = len(q)
    D = np.full((L, L), np.inf)
    for i in range(L):
        for j in range(max(0, i - r), min(L, i + r + 1)):
            c = (float(q[i]) - float(x[j])) ** 2
            if i == 0 and j == 0:
                D[i, j] = c
            else:
                best = np.inf
                if i > 0:
                    best = min(best, D[i - 1, j])
                if j > 0:
                    best = min(best, D[i, j - 1])
                if i > 0 and j > 0:
                    best = min(best, D[i - 1, j - 1])
                D[i, j] = c + best
    return D[L - 1, L - 1]


def _inputs(raw, queries, znorm: bool, device):
    """The collection and the queries as float32 tensors on the device
    (None: "cuda", raising without it), z-normalized if asked."""
    from repro_torch.api import resolve_device
    dev = resolve_device(device)
    x = torch.as_tensor(raw, dtype=torch.float32, device=dev)
    qs = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    if znorm:
        x, qs = isax.znormalize(x), isax.znormalize(qs)
    return x.contiguous(), qs.contiguous()


def search_dtw(raw, queries, *, r: int = 8, round_k: int = 32,
               znorm: bool = True, device=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact DTW 1-NN: LB_Keogh prune -> banded-DTW refine in LB order.

    raw: (N, L); queries: (Q, L), numpy or tensors.  Returns (dtw distance
    (Q,) float32, id (Q,) int32, -1 where no candidate was taken) on
    `device` (None: "cuda", RuntimeError without one; pass device="cpu"
    for the plain versions)."""
    x, qs = _inputs(raw, queries, znorm, device)
    dist, ids = [], []
    for g0 in range(0, qs.shape[0], GROUP):
        qg = qs[g0:g0 + GROUP]
        lb = kdtw.lb_keogh(qg, x, r=r)
        sorted_lb, order = torch.sort(lb, dim=1, stable=True)
        del lb
        bsf, best, _, _ = kdtw.dtw_search(qg, x, sorted_lb, order, r=r,
                                          round_k=round_k)
        dist.append(torch.sqrt(bsf))
        ids.append(best)
    if not dist:
        return (torch.empty(0, dtype=torch.float32, device=x.device),
                torch.empty(0, dtype=torch.int32, device=x.device))
    return torch.cat(dist), torch.cat(ids)


def search_dtw_bruteforce(raw, queries, *, r: int = 8, znorm: bool = True,
                          device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Banded DTW of each query against every series (N >= 1): (distance
    (Q,) float32, id (Q,) int32, the first on ties), on the device as
    `search_dtw`."""
    x, qs = _inputs(raw, queries, znorm, device)
    d2, ids = kdtw.dtw_scan(qs, x, r=r)
    return torch.sqrt(d2), ids
