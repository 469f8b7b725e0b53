"""Micro-batcher: pending queries -> padded, shape-bucketed batches.

The port's copy of `repro.serve.batcher` (numpy only): the same buckets,
group key, padding and chunking, so both packages form the same batches
from the same pending list.  A captured CUDA graph, like an XLA
executable, is shape-monomorphic, so a serving layer that dispatched
every submit() at its natural (Q, k) would capture an unbounded family
of plans.  Instead, pending queries are grouped by (epoch, k, knobs) — a
batch can only run against ONE snapshot, one top-k width and one
captured plan (so an approx quality tier never shares a batch with the
exact tier) — concatenated in arrival order, chunked at `max_batch`, and
each chunk is padded up to the smallest power-of-two bucket that holds
it.  The PlanCache then only ever sees the fixed bucket set {1, 2, 4,
..., max_batch}, one plan each per epoch.

Padding replicates the chunk's last real query row: real data
z-normalizes cleanly (an all-zeros pad row would hit the zero-variance
path), the padded rows' results are simply never read back, and the
wasted slots are accounted in `QueryEngine.stats()["batches"]
["padded_slots"]`.  A row's answer does not depend on the rows padded
around it (`repro_torch.core.search`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def shape_buckets(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to (and always including) max_batch."""
    out: List[int] = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket holding n rows (callers chunk to max_batch first)."""
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"{n} rows exceed the largest bucket {buckets[-1]}")


@dataclasses.dataclass
class Pending:
    """One submit() call (or the cache-missed slice of one) waiting to
    be batched.

    `row0` is the first row of `future` these queries correspond to: a
    submit whose leading rows were served from the result cache enqueues
    only the missed run, and form() offsets the segment map by `row0` so
    delivery still lands in the right future rows.  `deadline` is an
    absolute `time.monotonic()` instant (None = wait forever); the
    engine fails pendings past it with DeadlineExceeded instead of
    forming them, and its linger loop dispatches early rather than
    lingering past the earliest deadline."""
    queries: np.ndarray                 # (m, L) float32
    k: int
    epoch: int
    future: object                      # SearchFuture
    submitted_at: float
    deadline: Optional[float] = None    # absolute monotonic, None = never
    row0: int = 0                       # first future row of this slice
    priority: str = "interactive"       # admission class; batch sheds first
    knobs: object = None                # resolved plan Knobs (None = engine
                                        # default/exact tier)
    tier: str = "exact"                 # quality tier label for stats


def earliest_deadline(pending: Sequence[Pending]) -> Optional[float]:
    """The soonest absolute deadline in `pending` (None when none set).

    The engine's linger loop caps its bucket-fill wait at this instant
    so a nearly-due query dispatches in a partial bucket instead of
    expiring while the batcher waits for padding to fill."""
    ddls = [p.deadline for p in pending if p.deadline is not None]
    return min(ddls) if ddls else None


@dataclasses.dataclass
class Batch:
    """One padded dispatch unit bound to a single epoch snapshot.

    `segments` maps batch rows back to the submitting futures:
    (future, dst_row_in_batch, src_row_in_future, n_rows).  The query
    matrix stays host-side (np) so a journal helper can re-execute the
    batch after the plan's own query buffer was overwritten."""
    queries: np.ndarray                 # (bucket_q, L) padded
    k: int
    epoch: int
    n_real: int
    segments: List[Tuple[object, int, int, int]]
    formed_at: float
    part_id: int = -1
    knobs: object = None                # the group's resolved plan Knobs
    tier: str = "exact"                 # quality tier label for stats

    @property
    def padded_slots(self) -> int:
        return self.queries.shape[0] - self.n_real


class MicroBatcher:
    """Stateless batch former over a drained pending list."""

    def __init__(self, max_batch: int,
                 buckets: Optional[Sequence[int]] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = max_batch
        self.buckets = tuple(buckets) if buckets else shape_buckets(max_batch)

    def form(self, pending: Sequence[Pending],
             now: Optional[float] = None) -> List[Batch]:
        """Group by (epoch, k) in arrival order, chunk, pad to buckets.

        Deadline semantics: a pending whose `deadline` has passed `now`
        is dropped here (never formed) — the engine fails its future
        with DeadlineExceeded *before* calling form(), so the skip is a
        belt-and-braces guard against racing clocks, not the primary
        expiry path.  Live deadlines don't change grouping: closing a
        bucket early happens in the engine's linger loop (which stops
        waiting for padding at `earliest_deadline`), because by the time
        form() runs the decision to dispatch now has already been made.
        """
        if now is None:
            now = time.monotonic()
        pending = [p for p in pending
                   if p.deadline is None or p.deadline > now]
        # knobs joins the group key: a batch runs ONE compiled plan, so
        # exact and approx-tier pendings may never share a batch even at
        # the same (epoch, k) — aliasing them would serve one tier's
        # queries with the other tier's program
        groups: Dict[Tuple, List[Pending]] = {}
        for p in pending:
            groups.setdefault((p.epoch, p.k, p.knobs, p.tier), []).append(p)

        batches: List[Batch] = []
        for (epoch, k, knobs, tier), items in groups.items():
            rows: List[np.ndarray] = []
            segments: List[Tuple[object, int, int, int]] = []
            n = 0

            def close():
                nonlocal rows, segments, n
                if not n:
                    return
                bucket = bucket_for(n, self.buckets)
                if bucket > n:                   # pad with the last real row
                    rows.append(np.repeat(rows[-1][-1:], bucket - n, axis=0))
                batches.append(Batch(
                    queries=np.concatenate(rows, axis=0), k=k, epoch=epoch,
                    n_real=n, segments=segments, formed_at=now,
                    knobs=knobs, tier=tier))
                rows, segments, n = [], [], 0

            for p in items:
                src = 0
                m = p.queries.shape[0]
                while src < m:
                    take = min(self.max_batch - n, m - src)
                    segments.append((p.future, n, p.row0 + src, take))
                    rows.append(p.queries[src:src + take])
                    n += take
                    src += take
                    if n == self.max_batch:
                        close()
            close()
        return batches
