"""Deliberately-broken engine and plan-cache variants used to validate
the checker.

These are the meta-test fixtures: each class reintroduces one concrete
concurrency bug that the correct QueryEngine or PlanCache prevents, and
the schedule explorer (analysis/checker) must CATCH it within a bounded
schedule budget — proving the invariant machinery has teeth, not just
that the shipped code happens to pass.  The port's copies of repro's two
engine bugs, plus one of the port's own: `DoubleCapturePlanCache`.

Never import these outside tests.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.analysis.hooks import sync_point
from repro_torch.serve.engine import QueryEngine
from repro_torch.serve.plan_cache import PlanCache

__all__ = ["DoubleCapturePlanCache", "DoubleExecuteEngine",
           "MutableSnapshotEngine"]


class DoubleExecuteEngine(QueryEngine):
    """Drops the `is_done` re-check before delivery.

    The correct `_execute_part` re-validates the journal's done flag
    under _cv before delivering, because a helper may have force-stolen
    and completed the part while this thread sat between plan execution
    and delivery.  Without the re-check, the losing racer delivers the
    same rows a second time — the checker's exactly-once-delivery
    invariant (fill count per row == 1) must flag it."""

    def _execute_part(self, pid: int, worker: int) -> None:
        with self._cv:
            batch = self._batches.get(pid)
            if batch is None:
                return
            snap = self._snapshots[batch.epoch]
        sync_point("engine.execute.run", pid)
        plan = self.plans.get(snap, batch.queries.shape[0], batch.k,
                              self._knobs)
        d, i, rounds = plan.run(batch.queries)
        now = time.monotonic()
        sync_point("engine.execute.deliver", pid)
        with self._cv:
            # BUG: no `if self._journal.is_done(pid): return` here
            if not self._journal.is_done(pid):
                self._journal.mark_done(pid)
            self._dispatched += 1
            for fut, dst, src, n in batch.segments:
                if fut._fill(src, d[dst:dst + n], i[dst:dst + n], now):
                    self._completed += 1
            self._batches.pop(pid, None)
            self._journal.prune_done()
            self._gc_snapshots()
            self._cv.notify_all()
        self._journal.persist()


class MutableSnapshotEngine(QueryEngine):
    """Mutates the published snapshot in place instead of publishing.

    The correct add() buffers the rows and publishes a NEW epoch; this
    variant smashes the delta into the CURRENT epoch's frozen Snapshot,
    so an in-flight batch that captured the object sees data from after
    its submit epoch.  The checker's publish-time-vs-end fingerprint
    comparison must flag the mutation (and the epoch-bound oracle check
    usually fails with it)."""

    def add(self, batch, *, ttl_s=None) -> "QueryEngine":
        sync_point("engine.add")
        with self._wlock:
            self._index.add(batch)
            with self._cv:
                snap = self._snapshots[self._epoch]
            delta = self._index.delta_rows
            # BUG: in-place mutation of a published frozen Snapshot
            object.__setattr__(snap, "delta_rows",
                               None if delta is None else np.asarray(delta))
            object.__setattr__(snap, "n_total", self._index.n_series)
        return self


class DoubleCapturePlanCache(PlanCache):
    """Retires a key's capture under one hold of the cache lock and
    stores its plan under a second, the order `PlanCache.get` had before
    both moved into one critical section.  A thread that misses the key
    between the two holds finds neither a plan nor a capture in flight
    and captures the key again — the checker's one-capture invariant
    (`PlanCacheScenario`: at most one plan made per key) must flag it."""

    def _make(self, key, making, snapshot, bucket_q, k, knobs):
        sync_point("plan_cache.get.capture", key)
        plan = self._construct(key, snapshot, bucket_q, k, knobs)
        with self._lock:
            self._making.pop(key, None)      # BUG: the first hold
        sync_point("plan_cache.get.store", key)
        with self._lock:                     # the second hold
            self.misses += 1
            if snapshot.epoch not in self._dropped:
                plan = self._plans.setdefault(key, plan)
        making.plan = plan
        making.done.set()
        return plan
