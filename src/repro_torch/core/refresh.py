"""Refresh (paper Section IV, Algorithms 2-3): locality-aware lock-freedom.

The port's copy of `repro.core.refresh`.  A faithful host-level
implementation of the Refresh transformation:

  * the workload is split into k parts (recursively: chunks -> groups ->
    elements, three levels, exactly as FreSh's buffer-creation stage);
  * a done flag d_i per part, a help flag h_i per non-leaf part;
  * threads acquire parts through FAI counter objects (owner path), process
    them in EXPEDITIVE mode (no synchronization) while h_i stays False,
    switching to STANDARD mode when a helper arrives;
  * after exhausting the counters, each thread scans the done flags, backs
    off proportionally to its measured average part time T_avg, and HELPS
    any part still unfinished (standard mode), periodically re-checking d_i;
  * a thread that finishes its helping scan knows the whole stage is done —
    no barrier is needed (this is what makes the construction lock-free).

Progress guarantee reproduced here: as long as at least one worker keeps
taking steps, every element is processed at least once and run() terminates,
even if other workers are delayed arbitrarily or crash permanently
(simulated via injectors).  This is the property Figures 7-8 of the paper
measure.

Python-specific notes (recorded for honesty):
  * FAI is `itertools.count.__next__`, which is atomic under the GIL — the
    same single-RMW cost model as the paper's FAI.
  * done/help flags are plain list slots; racy read/set of a bool is benign
    (idempotent monotonic writes), exactly as in the paper.
  * a "crash" is a worker raising WorkerCrash: the thread exits without
    setting any flags — indistinguishable, to the others, from a stopped
    thread, which is the right failure model.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

from repro_torch.analysis.hooks import sync_point

from .traverse import Executor, StageStats

EXPEDITIVE = "expeditive"
STANDARD = "standard"


class WorkerCrash(Exception):
    """Raised by a crash injector to simulate a permanent thread failure."""


class WorkerDelay(Exception):
    """Never raised; delay injectors just sleep.  Placeholder for clarity."""


class CounterObject:
    """FAI-based work-assignment counter (paper Section V-A).

    NEXTINDEX returns successive indices; callers stop when >= limit.
    itertools.count.__next__ is a single GIL-atomic fetch-and-increment.
    """

    __slots__ = ("_c", "limit")

    def __init__(self, limit: int):
        self._c = itertools.count()
        self.limit = limit

    def next_index(self) -> int:
        # schedulable point BEFORE the FAI: the increment itself is one
        # atomic op, but which thread performs it next is a real race the
        # checker must control
        sync_point("refresh.fai", self)
        return next(self._c)


class Atomic:
    """GIL-atomic counter with a readable value (instrumentation only)."""

    __slots__ = ("_v", "_lock")

    def __init__(self):
        self._v = 0
        self._lock = threading.Lock()

    def inc(self) -> None:
        with self._lock:
            self._v += 1

    @property
    def value(self) -> int:
        return self._v


@dataclass
class Injectors:
    """Fault / delay injection for the paper's Figures 7-8 experiments.

    delay(thread_id, level, index) -> seconds to sleep before processing
    crash(thread_id, level, index) -> True to crash the worker permanently
    """
    delay: Optional[Callable[[int, int, int], float]] = None
    crash: Optional[Callable[[int, int, int], bool]] = None

    @classmethod
    def crashing(cls, worker_ids, after: int = 0) -> "Injectors":
        """Crash each listed worker permanently at its `after`-th payload
        application (0 = before it processes anything).  The per-worker
        counters are only ever touched by their own thread, so no lock is
        needed.  The canonical Fig. 8 injector."""
        ids = frozenset(worker_ids)
        counts: dict = {}
        def crash(tid: int, level: int, idx: int) -> bool:
            if tid not in ids:
                return False
            c = counts.get(tid, 0)
            counts[tid] = c + 1
            return c >= after
        return cls(crash=crash)

    @classmethod
    def delaying(cls, seconds: float, worker_ids=None,
                 every: int = 1) -> "Injectors":
        """Sleep `seconds` before every `every`-th element, on all workers
        or just `worker_ids` — the Fig. 7 straggler injector."""
        ids = None if worker_ids is None else frozenset(worker_ids)
        def delay(tid: int, level: int, idx: int) -> float:
            if ids is not None and tid not in ids:
                return 0.0
            return seconds if (idx % max(1, every)) == 0 else 0.0
        return cls(delay=delay)


class _Level:
    """One recursion level: parts with done flags, help flags, a counter."""

    __slots__ = ("n", "done", "help", "counter")

    def __init__(self, n: int):
        self.n = n
        self.done = [False] * n
        self.help = [False] * n
        self.counter = CounterObject(n)


class RefreshRun:
    """One TRAVERSE execution under Refresh over a 3-level workload split.

    n_elements are partitioned into `chunks` chunks of `groups` groups each
    (the last chunk/group may be ragged).  process(element_index, mode) is
    the payload (BUFFERCREATION etc. in the paper's pseudocode).
    """

    def __init__(self,
                 n_elements: int,
                 process: Callable[[int, str], None],
                 *,
                 n_threads: int = 4,
                 chunks: Optional[int] = None,
                 groups_per_chunk: int = 8,
                 backoff_factor: float = 0.5,
                 help_check_period: int = 16,
                 injectors: Optional[Injectors] = None):
        self.n_elements = n_elements
        self.process = process
        self.n_threads = max(1, n_threads)
        self.chunks = chunks if chunks is not None else self.n_threads
        self.chunks = max(1, min(self.chunks, n_elements)) if n_elements else 1
        self.groups_per_chunk = max(1, groups_per_chunk)
        self.backoff_factor = backoff_factor
        self.help_check_period = max(1, help_check_period)
        self.injectors = injectors or Injectors()

        # --- static 3-level decomposition -------------------------------
        # chunk c covers elements [chunk_lo[c], chunk_hi[c]); each chunk is
        # split into <= groups_per_chunk groups of consecutive elements.
        self.chunk_bounds = _split(n_elements, self.chunks)
        self.group_bounds: List[List[tuple]] = [
            _split_range(lo, hi, self.groups_per_chunk)
            for (lo, hi) in self.chunk_bounds
        ]

        self.L1 = _Level(self.chunks)                       # chunks
        self.L2 = [_Level(len(g)) for g in self.group_bounds]  # groups
        self.done_elem = [False] * n_elements               # element done flags

        # --- instrumentation --------------------------------------------
        self.applications = Atomic()            # total payload invocations
        self.applied_log: List[int] = []        # element ids (for property tests)
        self._applied_lock = threading.Lock()
        self.helped_parts = Atomic()
        self.mode_switches = Atomic()
        self.crashed = Atomic()
        self._t_avg = [0.0] * self.n_threads    # per-thread mean group time
        self._t_cnt = [0] * self.n_threads

    # -------------------------------------------------------------- public
    def run(self) -> StageStats:
        t0 = time.perf_counter()
        if self.n_elements == 0:
            return StageStats(wall_time=0.0)
        threads = [threading.Thread(target=self._worker, args=(t,), daemon=True)
                   for t in range(self.n_threads)]
        per_thread = [0.0] * self.n_threads
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        stats = StageStats(
            wall_time=time.perf_counter() - t0,
            applications=self.applications.value,
            helped_parts=self.helped_parts.value,
            mode_switches=self.mode_switches.value,
            crashed_workers=self.crashed.value,
            per_thread_time=per_thread,
        )
        return stats

    def all_done(self) -> bool:
        return all(self.L1.done)

    # ------------------------------------------------------------- worker
    def _worker(self, tid: int) -> None:
        try:
            # ---- owner phase: acquire chunks via FAI (Alg. 2 lines 5-11)
            while True:
                i = self.L1.counter.next_index()
                if i >= self.L1.n:
                    break
                self._process_chunk(tid, i)
                sync_point("refresh.chunk.pre_done", i)
                self.L1.done[i] = True
            # ---- helping phase (Alg. 2 lines 12-17)
            for j in range(self.L1.n):
                if self.L1.done[j]:
                    continue
                self._backoff(tid)
                sync_point("refresh.help.scan", j)
                if self.L1.done[j]:
                    continue
                self.L1.help[j] = True          # alert owner -> standard mode
                self.helped_parts.inc()
                self._process_chunk(tid, j, helping=True)
                sync_point("refresh.chunk.pre_done", j)
                self.L1.done[j] = True
        except WorkerCrash:
            self.crashed.inc()
            return  # thread dies silently: no flags set, no cleanup

    def _process_chunk(self, tid: int, ci: int, helping: bool = False) -> None:
        """Level-2 Refresh over the groups of chunk ci."""
        lvl = self.L2[ci]
        # owner pass over groups
        while True:
            g = lvl.counter.next_index()
            if g >= lvl.n:
                break
            self._process_group(tid, ci, g)
            sync_point("refresh.group.pre_done", (ci, g))
            lvl.done[g] = True
        # helping pass over groups of this chunk
        for g in range(lvl.n):
            if lvl.done[g]:
                continue
            if not helping:
                self._backoff(tid)
                if lvl.done[g]:
                    continue
            lvl.help[g] = True
            self.helped_parts.inc()
            self._process_group(tid, ci, g, helping=True)
            sync_point("refresh.group.pre_done", (ci, g))
            lvl.done[g] = True

    def _process_group(self, tid: int, ci: int, gi: int,
                       helping: bool = False) -> None:
        """Level-3: elements of group gi of chunk ci.

        The owner runs EXPEDITIVE while the group's help flag stays False;
        it checks the flag periodically and switches to STANDARD when a
        helper arrives (Alg. 2 line 9).  Helpers always run STANDARD and
        skip elements whose done flag is already set.
        """
        lo, hi = self.group_bounds[ci][gi]
        lvl = self.L2[ci]
        mode = STANDARD if (helping or lvl.help[gi]) else EXPEDITIVE
        t0 = time.perf_counter()
        for e in range(lo, hi):
            if mode == EXPEDITIVE and (e - lo) % self.help_check_period == 0:
                if lvl.help[gi]:
                    mode = STANDARD
                    self.mode_switches.inc()
            if mode == STANDARD and self.done_elem[e]:
                continue  # someone else already finished this element
            self._maybe_inject(tid, 3, e)
            sync_point("refresh.elem", e)
            self.process(e, mode)
            self.applications.inc()
            with self._applied_lock:
                self.applied_log.append(e)
            # the payload-applied -> done-flag window: a thread stalled
            # here forces helpers to re-execute e (at-least-once), the
            # exact double-execution window the checker explores
            sync_point("refresh.elem.pre_done", e)
            self.done_elem[e] = True
        dt = time.perf_counter() - t0
        # update running mean part time (backoff base, Section V-A)
        c = self._t_cnt[tid] + 1
        self._t_avg[tid] += (dt - self._t_avg[tid]) / c
        self._t_cnt[tid] = c

    # ------------------------------------------------------------- helpers
    def _backoff(self, tid: int) -> None:
        """Optional backoff before helping: proportional to measured T_avg."""
        if self.backoff_factor <= 0:
            return
        t = self._t_avg[tid] * self.backoff_factor
        if t > 0:
            time.sleep(min(t, 0.05))  # cap: keep experiments fast

    def _maybe_inject(self, tid: int, level: int, idx: int) -> None:
        inj = self.injectors
        if inj.delay is not None:
            d = inj.delay(tid, level, idx)
            if d and d > 0:
                time.sleep(d)
        if inj.crash is not None and inj.crash(tid, level, idx):
            raise WorkerCrash(f"worker {tid} crashed at element {idx}")


class RefreshExecutor(Executor):
    """Executor strategy plugging Refresh under TraverseObject.TRAVERSE."""

    def __init__(self, n_threads: int = 4, groups_per_chunk: int = 8,
                 backoff_factor: float = 0.5,
                 injectors: Optional[Injectors] = None):
        self.n_threads = n_threads
        self.groups_per_chunk = groups_per_chunk
        self.backoff_factor = backoff_factor
        self.injectors = injectors
        self.last_stats: Optional[StageStats] = None
        self.last_applied: Optional[List[int]] = None

    def run(self, items: Sequence, f: Callable, param=None) -> None:
        def payload(i: int, mode: str) -> None:
            e = items[i]
            if param is None:
                f(e)
            else:
                f(e, param)

        rr = RefreshRun(len(items), payload,
                        n_threads=self.n_threads,
                        groups_per_chunk=self.groups_per_chunk,
                        backoff_factor=self.backoff_factor,
                        injectors=self.injectors)
        self.last_stats = rr.run()
        self.last_applied = rr.applied_log
        if not rr.all_done() and rr.crashed.value == 0:
            raise RuntimeError("Refresh finished with unfinished parts and "
                               "no crashed workers: scheduler bug")


# --------------------------------------------------------------------------
def _split(n: int, k: int) -> List[tuple]:
    """Split range(n) into k near-equal [lo, hi) spans (load balancing)."""
    k = max(1, k)
    base, rem = divmod(n, k)
    out, lo = [], 0
    for i in range(k):
        hi = lo + base + (1 if i < rem else 0)
        out.append((lo, hi))
        lo = hi
    return out


def _split_range(lo: int, hi: int, k: int) -> List[tuple]:
    spans = _split(hi - lo, min(k, max(1, hi - lo)))
    return [(lo + a, lo + b) for (a, b) in spans if b > a] or [(lo, hi)]
