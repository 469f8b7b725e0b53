"""k-NN search over the flat index, local (one device) and sharded:
exact, or approximate under the quality stop rules.

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
and merged in (`merge_delta_topk`, `snapshot_search_impl`).  repro's pure
plans `search_plan` and `snapshot_search` take its keywords and run
these.

`run_search` resolves the knobs from `config=` / `tune=` as repro's does;
`search` and `make_sharded_search` are repro's deprecated free functions,
which warn.

The sharded plan (`shard_index`, `build_sharded_plan` -> `ShardedPlan`,
`sharded_view_search`) is repro's expeditive/standard search over leaf
blocks on the slots of a mesh: one lower-bound launch and queue a shard,
then rounds of one `refine_topk` launch a shard against local buffers,
with the global k-th bound published every `sync_every` rounds.

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
import threading
import warnings
from typing import Optional, Tuple

import torch

from repro_torch.kernels.isax_summarize import summarize_rows
from repro_torch.kernels.lb_distance import lb_distance
from repro_torch.kernels.ref import BIG
from repro_torch.kernels.refine import refine_topk
from repro_torch.kernels.refine_search import refine_search
from repro_torch.runtime.sharding import Mesh, Sharded, place

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
               round_leaves: Optional[int] = None, znorm: bool = True,
               max_rounds: Optional[int] = None,
               pq_budget: Optional[int] = None, stop_eps: float = 0.0,
               stop_leaves: Optional[int] = None, tune=None, config=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Knob resolution and `search_plan_impl`, with the k == 1 squeeze:
    (Q,) arrays for k == 1, (Q, k) ascending otherwise.

    round_leaves / pq_budget resolve as repro's do: the explicit argument,
    else the field of `config` (an IndexConfig) when set, else `tune` (a
    fresh autotune TuneConfig), else 8 / uncapped.  `stop_eps` /
    `stop_leaves` are the quality stop rules (defaults: exact)."""
    t = tune
    K = _resolve_knob(round_leaves, config, "round_leaves",
                      t.round_leaves if t else 8)
    pq_budget = _resolve_knob(pq_budget, config, "pq_budget",
                              t.pq_budget if t else None)
    d, i, _ = search_plan_impl(idx, queries, k=k, round_leaves=K,
                               znorm=znorm, max_rounds=max_rounds,
                               pq_budget=pq_budget, stop_eps=stop_eps,
                               stop_leaves=stop_leaves)
    return squeeze_k(d, i, k)


def _warn_deprecated_free_function(old: str, new: str) -> None:
    warnings.warn(
        f"calling repro_torch.core.search.{old} directly is deprecated; use "
        f"{new} instead (see the migration table in the README)",
        DeprecationWarning, stacklevel=3)


def search(idx: FlatIndex, queries: torch.Tensor, *, k: int = 1,
           round_leaves: Optional[int] = None, znorm: bool = True,
           max_rounds: Optional[int] = None,
           pq_budget: Optional[int] = None,
           config=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """DEPRECATED free-function spelling of exact k-NN, repro's shim over
    `run_search`.  New code: `FreshIndex.search(q, k=...)` for one-shot
    batches, `FreshIndex.engine()` for serving loops."""
    _warn_deprecated_free_function(
        "search", "FreshIndex.search(q, k=...) or FreshIndex.engine()")
    return run_search(idx, queries, k=k, round_leaves=round_leaves,
                      znorm=znorm, max_rounds=max_rounds,
                      pq_budget=pq_budget, config=config)


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


_BACKENDS = ("ref", "pallas")


def _check_backend(backend: str) -> None:
    """repro's `backend` names how its round executes on the TPU (jnp or
    the Pallas kernels); the port runs the same kernels either way, so the
    knob is checked as repro checks it and changes nothing."""
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, "
                         f"got {backend!r}")


def search_plan(idx: FlatIndex, queries: torch.Tensor, *, k: int = 1,
                round_leaves: int = 8, znorm: bool = True,
                max_rounds: Optional[int] = None, backend: str = "ref",
                pq_budget: Optional[int] = None, stop_eps: float = 0.0,
                stop_leaves: Optional[int] = None, dma_depth: int = 1,
                block_q: int = 1
                ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """repro's pure plan `search_plan` under its keywords: (dist, ids,
    rounds) of `search_plan_impl`.  `backend`, `dma_depth` and `block_q`
    pick repro's TPU kernel structure, never what it returns; the port's
    one refinement kernel answers for each."""
    _check_backend(backend)
    return search_plan_impl(idx, queries, k=k, round_leaves=round_leaves,
                            znorm=znorm, max_rounds=max_rounds,
                            pq_budget=pq_budget, stop_eps=stop_eps,
                            stop_leaves=stop_leaves)


def snapshot_search(idx: FlatIndex, delta: torch.Tensor,
                    queries: torch.Tensor,
                    delta_alive: Optional[torch.Tensor] = None, *, k: int,
                    n_base: int, round_leaves: int = 8, znorm: bool = True,
                    max_rounds: Optional[int] = None, backend: str = "ref",
                    pq_budget: Optional[int] = None, stop_eps: float = 0.0,
                    stop_leaves: Optional[int] = None, dma_depth: int = 1,
                    block_q: int = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """repro's pure plan `snapshot_search` under its keywords: (dist,
    ids, rounds) of `snapshot_search_impl` (see `search_plan` for the
    kernel-structure knobs)."""
    _check_backend(backend)
    return snapshot_search_impl(idx, delta, queries, delta_alive, k=k,
                                n_base=n_base, round_leaves=round_leaves,
                                znorm=znorm, max_rounds=max_rounds,
                                pq_budget=pq_budget, stop_eps=stop_eps,
                                stop_leaves=stop_leaves)


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


# ===========================================================================
# Sharded search: leaves block-sharded over one mesh axis.
# ===========================================================================
def shard_index(idx: FlatIndex, mesh: Mesh, axis: str = "data"
                ) -> Tuple[FlatIndex, ...]:
    """The index cut into `mesh.shape[axis]` contiguous leaf blocks, block
    s (its leaves and their rows) on slot s of `axis`.  Where a slot's
    device is the index's own, every array of its block is a view of the
    index's, not a copy.  Raises ValueError unless the leaves divide
    evenly (`index.pad_leaves` first)."""
    D = mesh.shape[axis]
    if idx.n_leaves % D:
        raise ValueError(f"{idx.n_leaves} leaves do not divide into {D} "
                         f"shards; pad_leaves(idx, {D}) first")
    where = Sharded(mesh, axis)
    blocks = {f: place(getattr(idx, f), where) for f in FlatIndex._fields}
    return tuple(FlatIndex(**{f: blocks[f][s] for f in FlatIndex._fields})
                 for s in range(D))


def _resolve_knob(value, config, name: str, fallback):
    """Explicit argument, else the index config's field when set, else
    `fallback`."""
    if value is not None:
        return value
    if config is not None and getattr(config, name, None) is not None:
        return getattr(config, name)
    return fallback


# the rounds a sharded search launches between two reads of its loop
# condition: 4, doubling to 64
_FIRST_CHUNK, _MOST_CHUNK = 4, 64


class ShardedPlan:
    """The sharded search plan of one (mesh, axis, k, knobs):
    `plan(shards, queries)` -> (dist (Q, k), ids (Q, k), rounds), no
    squeeze; the counterpart of the function repro's
    `build_sharded_plan` returns.  `shards` is `shard_index`'s tuple.

    Each shard, on its slot's device: its own lower bounds (one
    `lb_distance` launch) and queue (`_pq_order`, capped by its own leaf
    count), then rounds against a LOCAL top-k buffer (expeditive mode),
    each one `refine_topk` launch; every `sync_every` rounds the global
    k-th bound, the min over shards of their k-th best, is published to
    every shard (standard mode).  A (query, shard) is live while its
    next lower bound lies below min(published, local k-th), scaled by
    float32(1/(1+eps)^2) under an eps stop rule; the loop runs while any
    is live and the cursor is below cap * K.  Then each shard re-ranks
    its winners in direct form (the sums through `_row_sq`), and the
    D * k entries, shard-major, are sorted ascending by a stable sort,
    which orders ties as `lax.top_k` of the gathered buffers does.
    `rounds` counts the loop's iterations, as repro's collective
    while_loop does.

    The condition is monotone: the bound only falls, a queue's lower
    bounds only rise and the cursor only grows, so once no (query,
    shard) is live every later round prunes every slot, leaves every
    buffer as it was, and keeps every pair dead.  So the plan launches
    rounds in chunks (4, doubling to 64), counts the live rounds on the
    device, and reads the condition and the count once a chunk: the
    bits and the count are those of a read every round.  It never
    launches a round at or past cap * K.  `rounds` (as counted),
    `rounds_launched` and `host_reads` sum what its calls did.

    Queries are prepared once (`prepare_rows`), on their own device,
    and copied to every slot; the answer comes back to that device.
    Slots on one device are worked as one group: one bound, one mask
    and one liveness test a round for all of them."""

    def __init__(self, mesh: Mesh, *, axis: str, k: int, round_leaves: int,
                 sync_every: int, max_rounds: Optional[int], znorm: bool,
                 pq_budget: Optional[int], stop_eps: float,
                 stop_leaves: Optional[int]):
        if sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got {sync_every}")
        self.mesh, self.axis = mesh, axis
        self.k, self.K, self.sync_every = k, round_leaves, sync_every
        self.max_rounds, self.znorm = max_rounds, znorm
        self.stop_eps = stop_eps
        self.inv_eps, self.leaf_budget = _stop_knobs(stop_eps, stop_leaves,
                                                     pq_budget)
        self.rounds = self.rounds_launched = self.host_reads = 0
        # the counters: engine workers share a plan
        self._lock = threading.Lock()

    def __call__(self, shards, queries: torch.Tensor):
        q, q_paa, q_sq = prepare_rows(queries, self.znorm,
                                      shards[0].paa.shape[1])
        return self.rows(shards, q, q_paa, q_sq)

    def rows(self, shards, q: torch.Tensor, q_paa: torch.Tensor,
             q_sq: torch.Tensor):
        """The plan on queries `prepare_rows` already made."""
        D = self.mesh.shape[self.axis]
        if len(shards) != D:
            raise ValueError(f"{len(shards)} shards for a mesh axis of {D}")
        home, (Q, L) = q.device, q.shape
        k, K = self.k, self.K
        nl = shards[0].n_leaves
        cap = _rounds_cap(nl, K, self.max_rounds, self.leaf_budget) \
            if nl else 0
        if Q == 0 or cap == 0:
            return (torch.full((Q, k), BIG ** 0.5, device=home),
                    torch.full((Q, k), -1, dtype=torch.int32, device=home),
                    0)
        M = shards[0].leaf_capacity
        groups = self._groups(shards, q, q_paa, q_sq, cap)
        bd, be = [None] * D, [None] * D            # shard s's buffer
        for g in groups:
            for s in g["members"]:
                bd[s] = torch.full((Q, k), BIG, device=g["dev"])
                be[s] = torch.zeros((Q, k), dtype=torch.int32,
                                    device=g["dev"])
        pb = torch.full((Q,), BIG, device=home)
        n_live = torch.zeros((), dtype=torch.int32, device=home)
        chunk = _FIRST_CHUNK
        read_at, r, launched, reads = chunk, 0, 0, 0
        count = None
        while r < cap:
            alive, live = self._alive(groups, bd, pb, r)
            if r == read_at:
                # one read a chunk: the count so far, and whether round r
                # is live (once it is not, no later round is)
                count, go = torch.stack([n_live, live.int()]).tolist()
                reads += 1
                if not go:
                    break
                chunk = min(2 * chunk, _MOST_CHUNK)
                read_at = r + chunk
            n_live += live
            for g, a in zip(groups, alive):
                for j, s in enumerate(g["members"]):
                    bd[s], be[s] = refine_topk(
                        g["q"], g["q_sq"], shards[s].series,
                        shards[s].sq_norms, g["order"][j, r], a[j], bd[s],
                        be[s], leaf_capacity=M, k=k)
            launched += 1
            if r % self.sync_every == self.sync_every - 1:
                kth = torch.stack([b[:, -1].to(home) for b in bd])
                pb = torch.minimum(pb, kth.amin(0))
            r += 1
        else:
            count = int(n_live)
            reads += 1
        with self._lock:
            self.rounds += count
            self.rounds_launched += launched
            self.host_reads += reads

        # each shard re-ranks its winners in direct form, one fixed order
        # a row; then the shard-major union, stable-sorted
        all_d, all_i = [], []
        for g in groups:
            for s in g["members"]:
                found = bd[s] < BIG
                e = be[s].long()
                d_exact = _row_sq(g["q"][:, None, :]
                                  - shards[s].series[e].float())
                all_d.append(torch.where(found, d_exact, bd[s]).to(home))
                all_i.append(torch.where(found, shards[s].perm[e],
                                         torch.full_like(be[s], -1)
                                         ).to(home))
        slot = [s for g in groups for s in g["members"]]
        all_d = torch.cat([all_d[slot.index(s)] for s in range(D)], dim=1)
        all_i = torch.cat([all_i[slot.index(s)] for s in range(D)], dim=1)
        d, pos = torch.sort(all_d, dim=1, stable=True)
        return d[:, :k].sqrt(), torch.gather(all_i, 1, pos[:, :k]), count

    @staticmethod
    def _group_key(slot: int, shard: FlatIndex):
        """The shards worked as one group share this key: their device."""
        return shard.series.device

    def _groups(self, shards, q, q_paa, q_sq, cap: int) -> list:
        """The shards grouped by device, in slot order: each group's
        queries, their norms, and its members' queues stacked as (G, cap,
        Q, K), so round r's slots of member j are one contiguous block."""
        by_key: dict = {}
        for s, sh in enumerate(shards):
            by_key.setdefault(self._group_key(s, sh), []).append(s)
        Q, L = q.shape
        groups = []
        for members in by_key.values():
            dev = shards[members[0]].series.device
            qd, pd, sqd = (t.to(dev) for t in (q, q_paa, q_sq))
            order, slb = [], []
            for s in members:
                lb = lb_distance(pd.contiguous(), shards[s].leaf_lo,
                                 shards[s].leaf_hi, series_len=L)
                o, b = _pq_order(lb, self.K, cap, self.leaf_budget)
                del lb
                order.append(o.view(Q, cap, self.K).transpose(0, 1))
                slb.append(b.view(Q, cap, self.K).transpose(0, 1))
            groups.append({
                "dev": dev, "members": members, "q": qd, "q_sq": sqd,
                "order": torch.stack(order), "slb": torch.stack(slb),
                "scale": (torch.tensor(self.inv_eps, dtype=torch.float32,
                                       device=dev)
                          if self.stop_eps else None)})
        return groups

    def _alive(self, groups, bd, pb, r: int):
        """Round r's (G, Q, K) prune masks, one a group, and whether any
        (query, shard) is live, a bool on the queries' device."""
        masks, lives = [], []
        for g in groups:
            kth = torch.stack([bd[s][:, -1] for s in g["members"]])
            bound = torch.minimum(pb.to(g["dev"]), kth)
            if g["scale"] is not None:
                bound = bound * g["scale"]
            a = g["slb"][:, r] < bound[..., None]
            masks.append(a)
            lives.append(a.any().to(pb.device))
        live = lives[0] if len(lives) == 1 else torch.stack(lives).any()
        return masks, live


def build_sharded_plan(mesh: Mesh, *, axis: str = "data", k: int = 1,
                       round_leaves: Optional[int] = None,
                       sync_every: int = 1,
                       max_rounds: Optional[int] = None, znorm: bool = True,
                       pq_budget: Optional[int] = None,
                       stop_eps: float = 0.0,
                       stop_leaves: Optional[int] = None,
                       tune=None, config=None) -> ShardedPlan:
    """The sharded search plan (see `ShardedPlan`): `(shards, queries) ->
    (dist, ids, rounds)`, (Q, k) outputs, no squeeze.

    round_leaves / pq_budget resolve from `config` (an IndexConfig) when
    unset, then from `tune` (a fresh autotune TuneConfig), then from the
    defaults 8 / uncapped, as repro's do.  `stop_eps` / `stop_leaves` are
    the quality stop rules, applied in the loop condition and the prune
    as in the local plan; `stop_leaves` caps the leaves visited PER
    SHARD, so a mesh of D shards visits at most D * stop_leaves.  The
    serving engine runs the very same object the facade runs."""
    t = tune
    K = _resolve_knob(round_leaves, config, "round_leaves",
                      t.round_leaves if t else 8)
    pq_budget = _resolve_knob(pq_budget, config, "pq_budget",
                              t.pq_budget if t else None)
    return ShardedPlan(mesh, axis=axis, k=k, round_leaves=K,
                       sync_every=sync_every, max_rounds=max_rounds,
                       znorm=znorm, pq_budget=pq_budget, stop_eps=stop_eps,
                       stop_leaves=stop_leaves)


def build_sharded_search(mesh: Mesh, **kwargs):
    """`build_sharded_plan` with the k == 1 squeeze: a function
    `(shards, queries) -> (dist, ids)`, (Q,) for k == 1, (Q, k)
    ascending otherwise."""
    plan = build_sharded_plan(mesh, **kwargs)

    def sharded_search(shards, queries):
        d, i, _ = plan(shards, queries)
        return squeeze_k(d, i, plan.k)

    return sharded_search


def make_sharded_search(mesh: Mesh, **kwargs):
    """DEPRECATED free-function spelling of the sharded search builder,
    repro's shim over `build_sharded_search`.  New code:
    `FreshIndex.shard(mesh)`, then `index.search(q, k=...)`."""
    _warn_deprecated_free_function(
        "make_sharded_search",
        "FreshIndex.shard(mesh) then index.search(q, k=...)")
    return build_sharded_search(mesh, **kwargs)


def sharded_view_search(plan: ShardedPlan, shards,
                        delta_rows: Optional[torch.Tensor],
                        delta_alive: Optional[torch.Tensor], n_base: int,
                        queries: torch.Tensor, *, znorm: bool):
    """The plan the sharded `FreshIndex.search` runs over one search view
    (the tombstone-masked shards, the delta rows as compaction will store
    them or None, their alive mask, the delta's id offset): (dist, ids,
    rounds), (Q, k) internal ids.  The queries are summarized once; the
    sharded plan and the delta scan take them as they are, as
    `view_search_device` does for a local index.  The serving engine's
    sharded plans run exactly this."""
    q, q_paa, q_sq = prepare_rows(queries, znorm, shards[0].paa.shape[1])
    d, i, rounds = plan.rows(shards, q, q_paa, q_sq)
    if delta_rows is None:
        return d, i, rounds
    md, mi = merge_delta_topk(delta_rows, q, d, i, delta_alive, k=plan.k,
                              n_base=n_base, znorm=False)
    return md, mi, rounds

