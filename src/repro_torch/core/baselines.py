"""Conventional lock-free baselines (paper Section VI, Figure 6d).

The port's copy of `repro.core.baselines`, on the port's `core.refresh`
and `core.traverse`.

These are the schemes FreSh is compared against.  Each is an Executor
(traverse.py) applying f at-least-once over an element list with N threads:

  * DoAllSplit  — RawData split into n_threads equal chunks; done flag per
                  element; each thread processes its chunk, then circularly
                  re-traverses the WHOLE array processing un-done elements.
  * FaiBased    — a single global FAI counter assigns one element at a time;
                  when exhausted, threads re-traverse looking for un-done
                  elements (helping by re-execution).
  * CasBased    — like FaiBased but threads CLAIM each element with CAS
                  before processing (per-element CAS contention).

All guarantee the traversing property and lock-freedom; all violate the
locality principles of Definition IV.1 (per-element assignment destroys data
locality; circular re-traversal duplicates work), which is why the paper —
and our benchmark harness — finds them slower than Refresh.

Also here: SingleQueueRefinement, the Figure-6d refinement baseline (all
threads hammer one shared priority queue with DeleteMin), contrasted with
FreSh's per-thread round-robin queue scheme (repro's search.py).
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Any, Callable, List, Optional, Sequence

from .refresh import CounterObject, Injectors, WorkerCrash, _split
from .traverse import Executor, StageStats


class _BaseExecutor(Executor):
    def __init__(self, n_threads: int = 4,
                 injectors: Optional[Injectors] = None):
        self.n_threads = max(1, n_threads)
        self.injectors = injectors or Injectors()
        self.last_stats: Optional[StageStats] = None
        self.last_applied: Optional[List[int]] = None

    def run(self, items: Sequence[Any], f: Callable, param=None) -> None:
        n = len(items)
        done = [False] * n
        applications = itertools.count()
        crashed = itertools.count()
        applied: List[int] = []
        applied_lock = threading.Lock()

        def payload(tid: int, i: int) -> None:
            inj = self.injectors
            if inj.delay is not None:
                d = inj.delay(tid, 3, i)
                if d and d > 0:
                    time.sleep(d)
            if inj.crash is not None and inj.crash(tid, 3, i):
                raise WorkerCrash
            f(items[i]) if param is None else f(items[i], param)
            next(applications)
            with applied_lock:
                applied.append(i)
            done[i] = True

        t0 = time.perf_counter()
        threads = [threading.Thread(target=self._worker_guard,
                                    args=(t, n, done, payload, crashed),
                                    daemon=True)
                   for t in range(self.n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        self.last_stats = StageStats(
            wall_time=time.perf_counter() - t0,
            applications=next(applications),
            crashed_workers=next(crashed),
        )
        self.last_applied = applied

    def _worker_guard(self, tid, n, done, payload, crashed):
        try:
            self._worker(tid, n, done, payload)
        except WorkerCrash:
            next(crashed)

    def _worker(self, tid: int, n: int, done: List[bool], payload) -> None:
        raise NotImplementedError


class DoAllSplit(_BaseExecutor):
    """Chunk-per-thread, then circular re-traversal of the whole array."""

    def _worker(self, tid, n, done, payload):
        bounds = _split(n, self.n_threads)
        lo, _ = bounds[tid % len(bounds)]
        # circular traversal starting at own chunk (paper's description)
        for k in range(n):
            i = (lo + k) % n
            if not done[i]:
                payload(tid, i)


class FaiBased(_BaseExecutor):
    """Global FAI assignment, then re-traversal for un-done elements."""

    def run(self, items, f, param=None):
        self._counter = CounterObject(len(items))
        super().run(items, f, param)

    def _worker(self, tid, n, done, payload):
        while True:
            i = self._counter.next_index()
            if i >= n:
                break
            if not done[i]:
                payload(tid, i)
        for i in range(n):            # helping pass
            if not done[i]:
                payload(tid, i)


class CasBased(_BaseExecutor):
    """Per-element CAS claim before processing."""

    def run(self, items, f, param=None):
        self._claim_lock = threading.Lock()  # models the CAS instruction
        self._claimed = [False] * len(items)
        super().run(items, f, param)

    def _cas_claim(self, i: int) -> bool:
        with self._claim_lock:
            if not self._claimed[i]:
                self._claimed[i] = True
                return True
            return False

    def _worker(self, tid, n, done, payload):
        for i in range(n):
            if not done[i] and self._cas_claim(i):
                payload(tid, i)
        for i in range(n):            # helping pass (claims may have crashed)
            if not done[i]:
                payload(tid, i)


class SingleQueueRefinement:
    """Figure-6d refinement baseline: ONE shared priority queue, all threads
    loop DeleteMin.  The queue is the Lindén-Jonsson role; contention on its
    head is the bottleneck the paper highlights.  FreSh instead uses several
    round-robin-filled array queues (search.py / benchmarks)."""

    def __init__(self, n_threads: int = 4):
        self.n_threads = max(1, n_threads)
        self._lock = threading.Lock()

    def run(self, entries: Sequence[tuple], process: Callable[[Any], None]
            ) -> StageStats:
        heap = list(entries)
        heapq.heapify(heap)
        applications = itertools.count()
        t0 = time.perf_counter()

        def worker():
            while True:
                with self._lock:          # DeleteMin on the shared queue
                    if not heap:
                        return
                    item = heapq.heappop(heap)
                process(item)
                next(applications)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        return StageStats(wall_time=time.perf_counter() - t0,
                          applications=next(applications))
