"""k-NN search over the flat index, local (one device) path: exact, or
approximate under the quality stop rules.

The counterpart of `repro.core.search`'s local plan:

  pruning     one lower-bound computation of every query against every
              leaf region (the lb_distance kernel);
  the PQ      a stable ascending sort of the lower bounds per query, so
              ties go to the lower leaf index as `jax.lax.top_k` orders
              them, kept to the entries the rounds may read (max_rounds,
              pq_budget, the stop rule's leaf cap);
  refinement  rounds of K leaves per query, each folding real distances
              into a per-query top-k buffer, until the query's next
              unrefined lower bound is not below its k-th best distance
              (scaled by 1/(1+eps)^2 under an eps stop rule), so the
              answer is exact at eps 0.  JAX's `while_loop` becomes one
              launch of the refine_search kernel, in which each query
              runs its own rounds; the batch's round count (the most any
              query ran) is read on the host once per search;
  re-rank     the winners' distances recomputed in direct form.

A pending delta (rows added since the last compaction) is scanned exactly
and merged in (`merge_delta_topk`, `snapshot_search_impl`).

Each `*_impl` plan has a `*_device` twin that leaves every query's round
count on the device as a (Q,) tensor: nothing of it reads the device
from the host, so a CUDA graph can hold the whole plan (the serving
engine's plans, `repro_torch.serve.plan_cache`).  A query's row of the
answer does not depend on the batch it lies in: the sums over a row (the
z-norm, the query's norm, the direct-form distances) run in the
summarize kernel's fixed order a row (`prepare_rows`, `_row_sq`), where
torch's reductions on the card pick their order from the shape.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.isax_summarize import summarize_rows
from repro_torch.kernels.lb_distance import lb_distance
from repro_torch.kernels.ref import BIG
from repro_torch.kernels.refine_search import refine_search

from . import isax
from .index import FlatIndex


def _rounds_cap(n_leaves: int, K: int, max_rounds: Optional[int] = None,
                pq_budget: Optional[int] = None) -> int:
    """Bound on refinement rounds: enough to cover every leaf, tightened
    by max_rounds and/or the pq_budget leaf allowance."""
    cap = -(-n_leaves // K)
    if max_rounds is not None:
        cap = min(cap, max_rounds)
    if pq_budget is not None:
        cap = min(cap, max(1, -(-pq_budget // K)))
    return cap


def _stop_knobs(stop_eps: float, stop_leaves: Optional[int],
                pq_budget: Optional[int]) -> Tuple[float, Optional[int]]:
    """Validate the early-termination knobs (the quality stop rules) and
    fold the `stop_leaves` visited-leaf cap into the PQ leaf budget.

    Returns `(inv_eps_sq, leaf_budget)`: the squared-space bound scale
    1/(1+eps)^2 (a Python float, exactly 1.0 in exact mode) by which the
    refinement multiplies the k-th best before testing a lower bound
    against it, and the combined leaf allowance (min of pq_budget and
    stop_leaves, None = uncapped).
    """
    if stop_eps < 0.0:
        raise ValueError(f"stop_eps must be >= 0, got {stop_eps}")
    if stop_leaves is not None and stop_leaves < 1:
        raise ValueError(f"stop_leaves must be >= 1 or None, "
                         f"got {stop_leaves}")
    inv = 1.0 if stop_eps == 0.0 else 1.0 / float(1.0 + stop_eps) ** 2
    if stop_leaves is None:
        budget = pq_budget
    elif pq_budget is None:
        budget = stop_leaves
    else:
        budget = min(pq_budget, stop_leaves)
    return inv, budget


def _pq_order(lb: torch.Tensor, K: int, n_rounds_cap: int,
              leaf_budget: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-query priority queue: leaf ids ascending in lower bound,
    ties to the lower leaf index.  Only the first R = min(n_rounds_cap *
    K, NL) entries can ever be read, further capped by `leaf_budget` (an
    exact cap on admitted leaves, not rounded up to whole rounds); they
    are padded with lb = BIG to n_rounds_cap * K entries, so every round
    reads K in-range slots and a padded slot never passes the pruning
    test."""
    NL = lb.shape[1]
    R = min(n_rounds_cap * K, NL)
    if leaf_budget is not None:
        R = max(1, min(R, leaf_budget))
    R = min(R, n_rounds_cap * K)        # max_rounds 0: no round reads one
    sorted_lb, order = torch.sort(lb, dim=1, stable=True)
    order, sorted_lb = order[:, :R], sorted_lb[:, :R]
    padw = n_rounds_cap * K - R
    if padw > 0:
        order = torch.nn.functional.pad(order, (0, padw))
        sorted_lb = torch.nn.functional.pad(sorted_lb, (0, padw), value=BIG)
    return order.to(torch.int32).contiguous(), sorted_lb.contiguous()


def prepare_rows(queries: torch.Tensor, znorm: bool, segments: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q, q_paa, q_sq): the queries as float32, z-normalized when
    `znorm`, their PAA at the index's segment count and their squared
    norms, through the summarize kernel (`summarize_rows`), which reduces
    each row in one fixed order: a query gets the same bits alone as in
    any batch.  Raises ValueError when the length does not divide into
    `segments`."""
    L = queries.shape[-1]
    if L % segments != 0:
        raise ValueError(f"query length {L} is not divisible by the index "
                         f"segment count {segments}")
    q, q_paa, _, q_sq = summarize_rows(queries.float().contiguous(),
                                       segments=segments, znorm=znorm)
    return q, q_paa, q_sq


def prepare_queries(queries: torch.Tensor, znorm: bool, segments: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalize queries and compute their PAA at the index's segment
    count (`prepare_rows` without the norms).  Raises ValueError when the
    length does not divide into it."""
    return prepare_rows(queries, znorm, segments)[:2]


def _row_sq(x: torch.Tensor) -> torch.Tensor:
    """The sum of squares over the last axis of x (..., L), one fixed
    order a row: the summarize kernel's squared norms.  The launch also
    writes a float32 copy of the rows, their PAA (at the largest power
    of two up to 16 that divides L) and their symbols, all unused: at
    the main cell's (2560, 256) re-rank that is 3.0 MB written."""
    L = x.shape[-1]
    sq = summarize_rows(x.reshape(-1, L).float().contiguous(),
                        segments=math.gcd(L, 16), znorm=False)[3]
    return sq.reshape(x.shape[:-1])


def leaf_lower_bounds(idx: FlatIndex, q_paa: torch.Tensor,
                      series_len: int) -> torch.Tensor:
    """(Q, n_leaves) squared lower bounds, the pruning stage."""
    return lb_distance(q_paa.contiguous(), idx.leaf_lo, idx.leaf_hi,
                       series_len=series_len)


def search_plan_device(idx: FlatIndex, queries: torch.Tensor, *,
                       k: int = 1, round_leaves: int = 8, znorm: bool = True,
                       max_rounds: Optional[int] = None,
                       pq_budget: Optional[int] = None,
                       stop_eps: float = 0.0,
                       stop_leaves: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`search_plan_impl` with the round count left on the device: (dist,
    original_id, rounds), rounds a (Q,) int32 tensor of each query's own
    rounds (zeros over an empty core).  Reads nothing back to the host,
    so a CUDA graph can capture it."""
    q, q_paa, q_sq = prepare_rows(queries, znorm, idx.paa.shape[1])
    return _search_rows(idx, q, q_paa, q_sq, k=k, round_leaves=round_leaves,
                        max_rounds=max_rounds, pq_budget=pq_budget,
                        stop_eps=stop_eps, stop_leaves=stop_leaves)


def _search_rows(idx: FlatIndex, q: torch.Tensor, q_paa: torch.Tensor,
                 q_sq: torch.Tensor, *, k: int, round_leaves: int,
                 max_rounds: Optional[int], pq_budget: Optional[int],
                 stop_eps: float, stop_leaves: Optional[int]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`search_plan_device` on queries `prepare_rows` already made."""
    inv_eps, leaf_budget = _stop_knobs(stop_eps, stop_leaves, pq_budget)
    L = idx.series.shape[1]
    Q = q.shape[0]
    K = round_leaves

    if idx.n_leaves == 0:              # an empty core (the bootstrap)
        return (torch.full((Q, k), BIG ** 0.5, device=q.device),
                torch.full((Q, k), -1, dtype=torch.int32, device=q.device),
                torch.zeros((Q,), dtype=torch.int32, device=q.device))
    M = idx.leaf_capacity
    lb = leaf_lower_bounds(idx, q_paa, L)                # (Q, n_leaves)
    cap = _rounds_cap(idx.n_leaves, K, max_rounds, leaf_budget)
    order, sorted_lb = _pq_order(lb, K, cap, leaf_budget)
    del lb

    bsf_d, bsf_e, rounds = refine_search(
        q, q_sq, idx.series, idx.sq_norms, order, sorted_lb,
        leaf_capacity=M, k=k, round_leaves=K, inv_eps=inv_eps)

    # the top-k set is exact; the matmul-form distance loses ~1e-3 absolute
    # to f32 cancellation.  Recompute the winners' distances in direct form
    # and re-sort the buffer by them.
    found = bsf_d < BIG
    e = bsf_e.long()
    ids = torch.where(found, idx.perm[e], torch.full_like(bsf_e, -1))
    d_exact = _row_sq(q[:, None, :] - idx.series[e].float())
    d = torch.where(found, d_exact, bsf_d)
    resort = torch.argsort(d, dim=1, stable=True)
    d = torch.gather(d, 1, resort).sqrt()
    ids = torch.gather(ids, 1, resort)
    return d, ids, rounds


def search_plan_impl(idx: FlatIndex, queries: torch.Tensor, *, k: int = 1,
                     round_leaves: int = 8, znorm: bool = True,
                     max_rounds: Optional[int] = None,
                     pq_budget: Optional[int] = None,
                     stop_eps: float = 0.0,
                     stop_leaves: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """k-NN of `queries` (Q, L) over `idx`, on idx's device, with every
    knob resolved.

    Returns (dist, original_id, rounds): dist and ids are (Q, k) ascending
    by distance; rounds is the number of refinement rounds the batch
    runs, the most any of its queries runs, as repro counts them (read on
    the host; `search_plan_device` leaves each query's on the device).
    Slots with no series carry id -1 and distance sqrt(BIG).

    Exact at the defaults.  `max_rounds` caps the rounds and `pq_budget`
    the leaves admitted to each queue (distances become upper bounds when
    either cuts the search short).  `stop_eps` / `stop_leaves` are the
    quality stop rules: stop once no unrefined lower bound lies below the
    k-th best scaled by 1/(1+eps)^2 (squared space), and cap the visited
    leaves by tightening the leaf budget.  At (0.0, None) the scale is
    1.0, and the k-th best times 1.0 is the k-th best bit for bit, so
    exact search keeps its bits.
    """
    d, ids, rounds = search_plan_device(
        idx, queries, k=k, round_leaves=round_leaves, znorm=znorm,
        max_rounds=max_rounds, pq_budget=pq_budget, stop_eps=stop_eps,
        stop_leaves=stop_leaves)
    return d, ids, batch_rounds(rounds)


def batch_rounds(rounds: torch.Tensor) -> int:
    """The batch's round count, the most any query ran (0 for none): the
    plan's one read of the device."""
    return int(rounds.max()) if rounds.numel() else 0


def squeeze_k(d: torch.Tensor, i: torch.Tensor, k: int):
    """The 1-NN interface: (Q, 1) -> (Q,) when k == 1."""
    if k == 1:
        return d[:, 0], i[:, 0]
    return d, i


def run_search(idx: FlatIndex, queries: torch.Tensor, *, k: int = 1,
               round_leaves: int = 8, znorm: bool = True,
               max_rounds: Optional[int] = None,
               pq_budget: Optional[int] = None, stop_eps: float = 0.0,
               stop_leaves: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`search_plan_impl` with the k == 1 squeeze: (Q,) arrays for k == 1,
    (Q, k) ascending otherwise."""
    d, i, _ = search_plan_impl(idx, queries, k=k, round_leaves=round_leaves,
                               znorm=znorm, max_rounds=max_rounds,
                               pq_budget=pq_budget, stop_eps=stop_eps,
                               stop_leaves=stop_leaves)
    return squeeze_k(d, i, k)


def _bruteforce_topk(raw: torch.Tensor, queries: torch.Tensor, *, k: int,
                     znorm: bool, alive: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, k) exact scan over all series: matmul-form selection, direct-form
    reported distances, both ascending with ties to the lower index.

    The selection's products run in float64, so no TF32 setting of the
    matmul changes the answer.  `alive` ((n,) bool, None = all rows)
    makes the scan tombstone-aware: dead rows' distances are masked to
    BIG after normalization; a dead row chosen because k exceeds the
    alive count reports distance sqrt(BIG) and id -1, like the index
    search's not-found slots."""
    x = isax.znormalize(raw).float() if znorm else raw.float()
    q = isax.znormalize(queries).float() if znorm else queries.float()
    xd, qd = x.double(), q.double()
    d2 = ((qd * qd).sum(-1)[:, None] + (xd * xd).sum(-1)[None, :]
          - 2.0 * qd @ xd.T).clamp_min(0.0)
    if alive is not None:
        d2 = torch.where(alive[None, :], d2, torch.full_like(d2, BIG))
    i = torch.sort(d2, dim=1, stable=True).indices[:, :k]
    d_exact = _row_sq(q[:, None, :] - x[i])
    if alive is not None:
        d_exact = torch.where(alive[i], d_exact, torch.full_like(d_exact,
                                                                 BIG))
    resort = torch.argsort(d_exact, dim=1, stable=True)
    d = torch.gather(d_exact, 1, resort).sqrt()
    i = torch.gather(i, 1, resort).to(torch.int32)
    if alive is not None:
        i = torch.where(alive[i.long()], i, torch.full_like(i, -1))
    return d, i


def _merge_topk(d_a: torch.Tensor, i_a: torch.Tensor, d_b: torch.Tensor,
                i_b: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold two (Q, *) candidate sets into the (Q, k) best, ties to set a
    and then the lower position, as `jax.lax.top_k` orders them (a stable
    sort of the concatenation)."""
    alld = torch.cat([d_a, d_b], dim=1)
    alli = torch.cat([i_a, i_b], dim=1)
    d, pos = torch.sort(alld, dim=1, stable=True)
    return d[:, :k], torch.gather(alli, 1, pos[:, :k])


def _shift_delta_ids(di: torch.Tensor, n_base: int,
                     delta_alive: Optional[torch.Tensor]) -> torch.Tensor:
    """Delta scan position -> series id: position p holds id n_base + p
    (n_base is the delta id offset).  With a tombstone mask, not-found
    slots carry -1 and stay -1."""
    if delta_alive is None:
        return di + n_base
    return torch.where(di >= 0, di + n_base, di)


def merge_delta_topk(delta: torch.Tensor, queries: torch.Tensor,
                     d: torch.Tensor, i: torch.Tensor,
                     delta_alive: Optional[torch.Tensor] = None, *, k: int,
                     n_base: int, znorm: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold an exact scan of the (m, L) delta into (Q, k) core results
    (d, i): delta ids continue at `n_base`, `delta_alive` masks its
    tombstoned rows, ties go to the core set."""
    kd = min(k, delta.shape[0])
    dd, di = _bruteforce_topk(delta, queries, k=kd, znorm=znorm,
                              alive=delta_alive)
    return _merge_topk(d, i, dd, _shift_delta_ids(di, n_base, delta_alive),
                       k)


def snapshot_search_device(idx: FlatIndex, delta: torch.Tensor,
                           queries: torch.Tensor,
                           delta_alive: Optional[torch.Tensor] = None, *,
                           k: int, n_base: int, round_leaves: int = 8,
                           znorm: bool = True,
                           max_rounds: Optional[int] = None,
                           pq_budget: Optional[int] = None,
                           stop_eps: float = 0.0,
                           stop_leaves: Optional[int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """`snapshot_search_impl` with each query's round count left on the
    device, a (Q,) int32 tensor (see `search_plan_device`)."""
    d, i, rounds = search_plan_device(idx, queries, k=k,
                                      round_leaves=round_leaves, znorm=znorm,
                                      max_rounds=max_rounds,
                                      pq_budget=pq_budget, stop_eps=stop_eps,
                                      stop_leaves=stop_leaves)
    md, mi = merge_delta_topk(delta, queries, d, i, delta_alive, k=k,
                              n_base=n_base, znorm=znorm)
    return md, mi, rounds


def snapshot_search_impl(idx: FlatIndex, delta: torch.Tensor,
                         queries: torch.Tensor,
                         delta_alive: Optional[torch.Tensor] = None, *,
                         k: int, n_base: int, round_leaves: int = 8,
                         znorm: bool = True,
                         max_rounds: Optional[int] = None,
                         pq_budget: Optional[int] = None,
                         stop_eps: float = 0.0,
                         stop_leaves: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """k-NN over a (core index, delta buffer) snapshot: the core (dead
    rows pre-masked, `maintenance.mask_core`) by `search_plan_impl`, the
    unsorted delta by an exact scan, merged by `merge_delta_topk`.
    `stop_eps` / `stop_leaves` apply to the core only: the delta scan
    stays exact.  Returns (dist, ids, rounds)."""
    d, i, rounds = snapshot_search_device(
        idx, delta, queries, delta_alive, k=k, n_base=n_base,
        round_leaves=round_leaves, znorm=znorm, max_rounds=max_rounds,
        pq_budget=pq_budget, stop_eps=stop_eps, stop_leaves=stop_leaves)
    return d, i, batch_rounds(rounds)


def view_search_device(core: FlatIndex, delta_rows: Optional[torch.Tensor],
                       delta_alive: Optional[torch.Tensor], n_base: int,
                       queries: torch.Tensor, *, k: int, znorm: bool,
                       round_leaves: int, pq_budget: Optional[int] = None,
                       max_rounds: Optional[int] = None,
                       stop_eps: float = 0.0,
                       stop_leaves: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plan `FreshIndex.search` runs over one search view (the
    tombstone-masked core, the delta rows as compaction will store them
    or None, their alive mask, the delta's id offset): (dist, ids,
    rounds (Q,)), (Q, k) internal ids.  The queries are summarized here
    once (`prepare_rows`: normalized, their PAA and norms), and the core
    plan and the delta scan take them as they are.  The serving engine's
    plans run exactly this, so a row the engine answers has the facade's
    bits."""
    q, q_paa, q_sq = prepare_rows(queries, znorm, core.paa.shape[1])
    d, i, rounds = _search_rows(core, q, q_paa, q_sq, k=k,
                                round_leaves=round_leaves,
                                max_rounds=max_rounds, pq_budget=pq_budget,
                                stop_eps=stop_eps, stop_leaves=stop_leaves)
    if delta_rows is None:
        return d, i, rounds
    md, mi = merge_delta_topk(delta_rows, q, d, i, delta_alive, k=k,
                              n_base=n_base, znorm=False)
    return md, mi, rounds


def search_bruteforce(raw: torch.Tensor, queries: torch.Tensor, *,
                      k: int = 1, znorm: bool = True,
                      alive: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k oracle: exact scan over all series (`alive` masks dead rows,
    see `_bruteforce_topk`).  (Q,) for k == 1, (Q, k) ascending
    otherwise."""
    d, i = _bruteforce_topk(raw, queries, k=k, znorm=znorm, alive=alive)
    return squeeze_k(d, i, k)
