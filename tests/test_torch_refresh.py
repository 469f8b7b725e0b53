"""The port's host plane (repro_torch.core.refresh, core.traverse and
analysis.hooks) against repro's on the same schedules.

* The static three-level split of a Refresh run is repro's.
* One worker with no backoff walks a fixed schedule: the sync points it
  passes, in order, and the elements it applies are repro's.
* Under crash and delay injectors every element is applied at least once
  (the traversing property), as in repro, and `traverse_complete` finishes
  even when every worker crashes.
"""

import threading

import pytest

from repro.analysis import hooks as jhooks
from repro.core import refresh as jrefresh
from repro.core import traverse as jtraverse
from repro_torch.analysis import hooks
from repro_torch.core import refresh, traverse


class Recorder:
    """A SyncHook that records every sync point and observation."""

    def __init__(self):
        self.events = []
        self._lock = threading.Lock()

    def sync(self, name, obj=None):
        with self._lock:
            self.events.append(("sync", name))

    def observe(self, name, obj=None):
        with self._lock:
            self.events.append(("observe", name))


@pytest.mark.parametrize("n,threads,groups", [(0, 4, 8), (1, 4, 8),
                                              (37, 3, 4), (200, 4, 8),
                                              (10, 16, 2)])
def test_static_split_is_repros(n, threads, groups):
    mine = refresh.RefreshRun(n, lambda e, m: None, n_threads=threads,
                              groups_per_chunk=groups)
    theirs = jrefresh.RefreshRun(n, lambda e, m: None, n_threads=threads,
                                 groups_per_chunk=groups)
    assert mine.chunk_bounds == theirs.chunk_bounds
    assert mine.group_bounds == theirs.group_bounds


@pytest.mark.parametrize("n", [1, 50, 131])
def test_one_worker_walks_repros_schedule(n):
    """With one worker and no backoff the run is deterministic: the same
    sync points in the same order, the same elements applied."""
    def run(ref, hk):
        rec = Recorder()
        applied = []
        rr = ref.RefreshRun(n, lambda e, mode: applied.append((e, mode)),
                            n_threads=1, backoff_factor=0.0)
        with hk.installed(rec):
            stats = rr.run()
        return rec.events, applied, stats.applications, rr.all_done()
    assert run(refresh, hooks) == run(jrefresh, jhooks)


def test_hooks_install_and_restore():
    rec = Recorder()
    assert hooks.set_sync_hook(None) is None
    with hooks.installed(rec):
        hooks.sync_point("a")
        hooks.observe("b")
    hooks.sync_point("c")                  # uninstalled: not recorded
    assert rec.events == [("sync", "a"), ("observe", "b")]


@pytest.mark.parametrize("injectors", [
    lambda ref: ref.Injectors.delaying(0.001, worker_ids={0}, every=3),
    lambda ref: ref.Injectors.crashing({1, 2}, after=1),
    lambda ref: ref.Injectors(crash=lambda t, lvl, i: t != 3 and i % 2 == 0),
])
def test_traversing_property_under_injectors(injectors):
    """Every element is applied at least once in both packages."""
    for ref, trav in ((refresh, traverse), (jrefresh, jtraverse)):
        ex = ref.RefreshExecutor(n_threads=4, injectors=injectors(ref))
        t = trav.ArrayTraverse(ex)
        for i in range(120):
            t.put(i)
        seen, lock = [], threading.Lock()

        def f(e, seen=seen, lock=lock):
            with lock:
                seen.append(e)
        t.traverse(f)
        assert trav.check_traversing_property(120, seen), ref.__name__
        assert ex.last_stats.applications >= 120


@pytest.mark.parametrize("workers", [1, 4])
def test_traverse_complete_finishes_when_every_worker_crashes(workers):
    """No worker survives; the caller applies every part itself, in both
    packages, and each part's payload runs at least once."""
    for ref, trav in ((refresh, traverse), (jrefresh, jtraverse)):
        ex = ref.RefreshExecutor(
            n_threads=workers,
            injectors=ref.Injectors.crashing(range(workers), after=0))
        hits = [0] * 25
        stats = trav.traverse_complete(
            ex, 25, lambda p, hits=hits: hits.__setitem__(p, hits[p] + 1))
        assert all(h >= 1 for h in hits), ref.__name__
        assert stats.crashed_workers == workers


def test_sequential_executor_is_repros():
    for trav in (traverse, jtraverse):
        t = trav.ArrayTraverse(trav.SequentialExecutor(), n_slots=3)
        for i in range(30):
            t.put(i, i % 3)
        seen = []
        t.traverse(seen.append, delete=True)
        assert seen == [i for s in range(3) for i in range(s, 30, 3)]
        assert t.snapshot() == []
    assert traverse.traverse_complete(traverse.SequentialExecutor(), 3,
                                      lambda p: None) is None
