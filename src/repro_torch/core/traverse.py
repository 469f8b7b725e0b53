"""Traverse objects (paper Section III).

A *traverse object* S stores elements of a universe U and supports

    PUT(S, e, param)              -- add element e
    TRAVERSE(S, f, param, del)    -- apply f to every distinct element at
                                     least once (traversing property);
                                     optionally delete traversed elements.

and an iSAX-based index is exactly four traverse objects chained:

    BC (buffer creation)  ->  TP (tree population)  ->  PS (pruning)
                          ->  RS (refinement)

with the *non-overlapping property*: every TRAVERSE on S starts only after
all PUTs of distinct elements into S are complete (Definition III.2).

This module provides the ADT plus concrete array-backed implementations used
by the host control plane (the port's copy of `repro.core.traverse`).  The
heavy math inside the f's runs in the port's CUDA kernels; the TRAVERSE
scheduling itself is delegated to a pluggable executor so the same
pipeline can run:

  * sequentially (oracle / tests),
  * under Refresh (lock-free, Section IV — see refresh.py).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, List, Optional, Sequence


class TraverseObject:
    """Abstract traverse object (Definition III.1)."""

    def put(self, e: Any, param: Any = None) -> None:
        raise NotImplementedError

    def traverse(self, f: Callable[..., Any], param: Any = None,
                 delete: bool = False) -> None:
        raise NotImplementedError


class ArrayTraverse(TraverseObject):
    """A traverse object backed by a list (the paper's array buffers).

    PUT appends; TRAVERSE applies f via the supplied executor.  When
    `n_slots` is given, PUT(e, slot) writes into a pre-sized slot array —
    this is how summarization buffers give each thread its own region
    (Section V-A: "Each thread uses its own part in each buffer").
    """

    def __init__(self, executor: "Executor", n_slots: Optional[int] = None):
        self._executor = executor
        self._lock = threading.Lock()
        if n_slots is None:
            self._items: List[Any] = []
            self._slots = None
        else:
            self._slots = [[] for _ in range(n_slots)]
            self._items = None

    def put(self, e: Any, param: Any = None) -> None:
        if self._slots is not None:
            # slot-addressed PUT: param is the slot id; slot lists are only
            # ever appended to by their owning thread => no lock needed.
            self._slots[param].append(e)
        else:
            with self._lock:
                self._items.append(e)

    def snapshot(self) -> List[Any]:
        if self._slots is not None:
            out: List[Any] = []
            for s in self._slots:
                out.extend(s)
            return out
        return list(self._items)

    def traverse(self, f: Callable[..., Any], param: Any = None,
                 delete: bool = False) -> None:
        items = self.snapshot()
        self._executor.run(items, f, param)
        if delete:
            if self._slots is not None:
                for s in self._slots:
                    s.clear()
            else:
                with self._lock:
                    self._items.clear()


class Executor:
    """Strategy interface: how TRAVERSE applies f over the element list."""

    def run(self, items: Sequence[Any], f: Callable[..., Any],
            param: Any = None) -> None:
        raise NotImplementedError


class SequentialExecutor(Executor):
    """Oracle executor: applies f exactly once per element, in order."""

    def run(self, items, f, param=None):
        for e in items:
            f(e) if param is None else f(e, param)


@dataclass
class StageStats:
    """Book-keeping returned by schedulers: used for the paper's measures."""
    wall_time: float = 0.0
    applications: int = 0            # >= len(items): helping may duplicate
    helped_parts: int = 0
    mode_switches: int = 0
    crashed_workers: int = 0
    per_thread_time: List[float] = field(default_factory=list)


def check_traversing_property(n_elements: int,
                              applied: Iterable[int]) -> bool:
    """True iff f was applied at least once on every distinct element."""
    seen = set(applied)
    return all(i in seen for i in range(n_elements))


def traverse_complete(executor: Executor, n_parts: int,
                      payload: Callable[[int], None]
                      ) -> Optional[StageStats]:
    """Drive `payload` over part ids [0, n_parts) through `executor`,
    then GUARANTEE completion.

    Refresh's progress property holds while at least one worker keeps
    taking steps; if a crash injector kills every worker, parts can be
    left unfinished.  The caller is always a live "worker" though, so
    after the executor returns we re-apply any part whose done flag never
    set — the same at-least-once helping rule the executors use, extended
    to the calling thread.  Payloads must therefore be idempotent (write
    deterministic values into disjoint output slots), which is exactly
    the contract `IndexBuilder`'s phase payloads keep.

    Returns the executor's StageStats when it records one (RefreshRun),
    else None (SequentialExecutor).
    """
    done = [False] * n_parts
    def apply(p: int) -> None:
        payload(p)
        done[p] = True
    executor.run(range(n_parts), apply)
    for p in range(n_parts):
        if not done[p]:
            apply(p)
    return getattr(executor, "last_stats", None)
