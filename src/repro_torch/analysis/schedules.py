"""A loom-style controlled scheduler over the `hooks.sync_point` seam.

The port's copy of `repro.analysis.schedules`.  It installs itself
through `repro_torch.analysis.hooks`, the seam the port's core/refresh.py,
runtime/journal.py, serve/engine.py, serve/plan_cache.py and api.py call.

The model (CHESS / loom): threads run REAL code, but every thread
registered with the scheduler parks at each `sync_point` it reaches; the
scheduler wakes exactly one parked thread at a time, so an interleaving
is fully described by the sequence of (thread, point) choices — a
*schedule*.  Two strategies generate schedules:

  * `DFSStrategy` — bounded-preemption systematic exploration.  Choices
    are ordered current-thread-first; switching away from a runnable
    current thread costs one unit of a preemption budget (Musuvathi &
    Qadeer's iterative context bounding: most concurrency bugs need very
    few preemptions).  Schedules are enumerated by depth-first
    backtracking with replay.
  * `RandomStrategy` — seeded uniform choice, optionally with PERMANENT
    STALLS: at a stall-eligible point a thread can be descheduled
    forever.  Unlike the crash injectors in core/refresh.py (a crashed
    thread vanishes), a stalled thread keeps whatever it half-did
    visible to the others — the adversarial-scheduler model of Atalar et
    al., and the hypothesis under which lock-freedom must still mean
    "someone always finishes".
    A scenario whose threads wait for each other in a loop of parks
    (serve/plan_cache.py's `plan_cache.get.wait`) needs this strategy:
    DFS runs the current thread first and would spin the waiter.

Lock discipline (enforced by construction, see hooks.py): sync points
only ever fire while the calling thread holds NO Python lock, so a
parked (or stalled) thread can never deadlock the others through a lock
it holds.  A controlled thread that still blocks outside a sync point
(a real lock cycle, an un-timed-out wait) trips the scheduler watchdog
and fails the run — that IS the checker detecting a liveness bug.

The scheduler is generic: scenarios and invariants live in
`analysis/checker.py`.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Set, Tuple)

from .hooks import SyncHook, installed

__all__ = ["ControlledScheduler", "DFSStrategy", "RandomStrategy",
           "RunResult", "SchedulerHang", "ScheduleLivelock", "Strategy"]

# thread lifecycle states
_RUNNING, _PARKED, _DONE, _STALLED, _FAILED = range(5)

START_POINT = "<start>"


class SchedulerHang(RuntimeError):
    """A controlled thread blocked outside any sync point (watchdog)."""


class ScheduleLivelock(RuntimeError):
    """The schedule exceeded max_steps without completing — no progress."""


class _AbandonRun(BaseException):
    """Raised inside stalled threads at teardown to unwind them.  Derives
    from BaseException so no library except-Exception clause swallows it."""


@dataclass
class RunResult:
    """One executed interleaving."""
    trace: Tuple[Tuple[str, str], ...]      # ((thread, point), ...) choices
    stalled: Tuple[str, ...]                # threads permanently stalled
    errors: Dict[str, BaseException]        # thread -> real exception
    steps: int
    diverged: bool = False                  # DFS replay left its prefix

    @property
    def ok(self) -> bool:
        return not self.errors

    def signature(self) -> int:
        """Hash identifying this interleaving (distinct-schedule count)."""
        return hash((self.trace, self.stalled))


class Strategy:
    """Schedule-generation strategy.  One instance drives MANY runs."""

    def begin_run(self) -> None:
        """Reset per-run state."""

    def choose(self, runnable: Sequence[str], points: Sequence[str],
               current: Optional[int]) -> Tuple[str, int]:
        """Pick the next action.

        runnable: names of parked threads, in stable registration order;
        points:   the sync-point name each is parked at;
        current:  index into runnable of the previously-running thread,
                  or None if it is no longer runnable.
        Returns ("run", i) to wake runnable[i], or ("stall", i) to
        deschedule runnable[i] forever.
        """
        raise NotImplementedError

    def end_run(self, result: RunResult) -> None:
        """Observe the finished run (DFS advances its prefix here)."""

    @property
    def exhausted(self) -> bool:
        """True when the strategy has no new schedules to offer."""
        return False


class RandomStrategy(Strategy):
    """Seeded uniform scheduling with optional permanent stalls.

    `p_stall` is the per-decision probability of permanently stalling an
    eligible thread (parked at a name in `stall_points`, with at least
    one other runnable thread left and fewer than `max_stalls` stalls so
    far).  Never stalls the last runnable thread: lock-freedom promises
    progress while SOME thread keeps taking steps, not under a scheduler
    that freezes everyone."""

    def __init__(self, seed: int = 0, p_stall: float = 0.0,
                 stall_points: Optional[Iterable[str]] = None,
                 max_stalls: int = 1):
        import random
        self._rng = random.Random(seed)
        self.p_stall = p_stall
        self.stall_points = frozenset(stall_points or ())
        self.max_stalls = max_stalls
        self._stalls_used = 0

    def begin_run(self) -> None:
        self._stalls_used = 0

    def choose(self, runnable, points, current):
        if (self.p_stall > 0 and self._stalls_used < self.max_stalls
                and len(runnable) > 1
                and self._rng.random() < self.p_stall):
            eligible = [i for i, p in enumerate(points)
                        if p in self.stall_points]
            if eligible:
                self._stalls_used += 1
                return "stall", self._rng.choice(eligible)
        return "run", self._rng.randrange(len(runnable))


class DFSStrategy(Strategy):
    """Bounded-preemption depth-first systematic exploration.

    Replay-based: each run follows the recorded prefix of choice RANKS,
    then defaults to rank 0 (current-thread-first ordering = run until
    the thread parks somewhere it must yield).  `end_run` advances the
    deepest incrementable rank.  With `max_preemptions=p`, a schedule may
    switch away from a runnable current thread at most p times; forced
    switches (current finished or stalled) are free.  Replay can diverge
    when the program is not schedule-deterministic; the run still counts
    (flagged in RunResult.diverged) and enumeration re-anchors on it."""

    def __init__(self, max_preemptions: int = 2):
        self.max_preemptions = max_preemptions
        self._prefix: List[int] = []
        self._log: List[Tuple[int, int]] = []   # (rank, n_choices) per step
        self._pos = 0
        self._preempts = 0
        self._diverged = False
        self._exhausted = False

    # choices are ranked current-first; rank r maps to a runnable index
    def _ranked(self, runnable, current):
        order = list(range(len(runnable)))
        if current is not None:
            order.remove(current)
            order.insert(0, current)
            if self._preempts >= self.max_preemptions:
                order = [current]       # budget gone: no voluntary switch
        return order

    def begin_run(self) -> None:
        self._pos = 0
        self._preempts = 0
        self._diverged = False
        self._log = []

    def choose(self, runnable, points, current):
        order = self._ranked(runnable, current)
        rank = 0
        if self._pos < len(self._prefix):
            rank = self._prefix[self._pos]
            if rank >= len(order):     # replay divergence: clamp + flag
                rank = len(order) - 1
                self._diverged = True
        self._log.append((rank, len(order)))
        self._pos += 1
        idx = order[rank]
        if current is not None and idx != current:
            self._preempts += 1
        return "run", idx

    def end_run(self, result: RunResult) -> None:
        result.diverged = self._diverged
        # advance: bump the deepest rank that still has a sibling
        for i in range(len(self._log) - 1, -1, -1):
            rank, n = self._log[i]
            if rank + 1 < n:
                self._prefix = [r for r, _ in self._log[:i]] + [rank + 1]
                return
        self._exhausted = True

    @property
    def exhausted(self) -> bool:
        return self._exhausted


class _Controlled:
    """Per-thread control block."""

    __slots__ = ("name", "thread", "state", "point", "go", "abandon",
                 "error")

    def __init__(self, name: str):
        self.name = name
        self.thread: Optional[threading.Thread] = None
        self.state = _RUNNING
        self.point = START_POINT
        self.go = threading.Event()
        self.abandon = False
        self.error: Optional[BaseException] = None


class _ControlledHook(SyncHook):
    """The SyncHook installed for one run: parks registered threads at
    parkable points, forwards observe events to the run's observer."""

    def __init__(self, scheduler: "ControlledScheduler",
                 parkable: Callable[[str], bool],
                 observer: Optional[Callable[[str, Any], None]]):
        self._sched = scheduler
        self._parkable = parkable
        self._observer = observer

    def sync(self, name: str, obj: Any = None) -> None:
        ctl = self._sched._by_ident.get(threading.get_ident())
        if ctl is None or not self._parkable(name):
            return
        self._sched._park(ctl, name)

    def observe(self, name: str, obj: Any = None) -> None:
        if self._observer is not None:
            self._observer(name, obj)


class ControlledScheduler:
    """Runs a set of thread functions under full schedule control.

    One scheduler instance executes MANY runs (`run()` per schedule); the
    strategy carries state across runs (DFS prefix, RNG stream).

    park_on: collection of sync-point names (or a predicate) this
    scenario schedules at.  Points not matched run straight through —
    that is how e.g. `journal.*` points stay inert inside engine
    scenarios where the journal is called under the engine's condition
    variable (parking there would violate the no-lock-held rule).
    """

    def __init__(self, strategy: Strategy,
                 park_on: Any = None,
                 max_steps: int = 20_000,
                 watchdog_s: float = 20.0):
        self.strategy = strategy
        if park_on is None:
            self._parkable = lambda name: True
        elif callable(park_on):
            self._parkable = park_on
        else:
            allowed = frozenset(park_on)
            self._parkable = lambda name: name in allowed
        self.max_steps = max_steps
        self.watchdog_s = watchdog_s
        self._qcv = threading.Condition()
        self._by_ident: Dict[int, _Controlled] = {}

    # ------------------------------------------------------------ threads
    def _park(self, ctl: _Controlled, name: str) -> None:
        with self._qcv:
            ctl.state = _PARKED
            ctl.point = name
            self._qcv.notify_all()
        ctl.go.wait()
        ctl.go.clear()
        if ctl.abandon:
            raise _AbandonRun()

    def _thread_main(self, ctl: _Controlled, fn: Callable[[], None]):
        try:
            self._park(ctl, START_POINT)    # scheduler controls step one
            fn()
            final = _DONE
        except _AbandonRun:
            final = _STALLED
        except BaseException as e:          # noqa: BLE001 — report, not raise
            ctl.error = e
            final = _FAILED
        with self._qcv:
            ctl.state = final
            self._qcv.notify_all()

    def _wait_quiescent(self, ctls: List[_Controlled]) -> None:
        with self._qcv:
            while any(c.state == _RUNNING for c in ctls):
                if not self._qcv.wait(timeout=self.watchdog_s):
                    stuck = [c.name for c in ctls if c.state == _RUNNING]
                    raise SchedulerHang(
                        f"threads {stuck} blocked outside any sync point "
                        f"for {self.watchdog_s}s — a real lock cycle or "
                        f"unbounded wait (liveness bug), or a sync_point "
                        f"missing on their path")

    # ---------------------------------------------------------------- run
    def run(self, fns: Sequence[Tuple[str, Callable[[], None]]],
            observer: Optional[Callable[[str, Any], None]] = None
            ) -> RunResult:
        """Execute one schedule over `fns` = [(name, callable), ...]."""
        ctls = [_Controlled(name) for name, _ in fns]
        self._by_ident = {}
        self.strategy.begin_run()
        trace: List[Tuple[str, str]] = []
        hook = _ControlledHook(self, self._parkable, observer)
        current: Optional[_Controlled] = None
        steps = 0
        try:
            with installed(hook):
                for ctl, (_, fn) in zip(ctls, fns):
                    t = threading.Thread(
                        target=self._thread_main, args=(ctl, fn),
                        name=f"sched-{ctl.name}", daemon=True)
                    ctl.thread = t
                    t.start()
                    self._by_ident[t.ident] = ctl
                self._wait_quiescent(ctls)
                while True:
                    runnable = [c for c in ctls if c.state == _PARKED]
                    if not runnable:
                        break               # everyone done/stalled/failed
                    cur_idx = (runnable.index(current)
                               if current in runnable else None)
                    kind, i = self.strategy.choose(
                        [c.name for c in runnable],
                        [c.point for c in runnable], cur_idx)
                    chosen = runnable[i]
                    if kind == "stall":
                        with self._qcv:
                            chosen.state = _STALLED
                        trace.append((chosen.name, f"stall@{chosen.point}"))
                        if current is chosen:
                            current = None
                        continue
                    trace.append((chosen.name, chosen.point))
                    current = chosen
                    with self._qcv:
                        chosen.state = _RUNNING
                    chosen.go.set()
                    self._wait_quiescent(ctls)
                    steps += 1
                    if steps > self.max_steps:
                        raise ScheduleLivelock(
                            f"schedule exceeded {self.max_steps} steps")
        finally:
            self._teardown(ctls)
        result = RunResult(
            trace=tuple(trace),
            stalled=tuple(c.name for c in ctls if c.state == _STALLED),
            errors={c.name: c.error for c in ctls if c.error is not None},
            steps=steps)
        self.strategy.end_run(result)
        return result

    def _teardown(self, ctls: List[_Controlled]) -> None:
        """Unwind every thread still parked (stalled or mid-failure)."""
        for c in ctls:
            c.abandon = True
            c.go.set()
        for c in ctls:
            if c.thread is not None:
                c.thread.join(timeout=5.0)
        self._by_ident = {}
