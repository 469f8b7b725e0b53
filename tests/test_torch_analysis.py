"""The port's race checker (repro_torch.analysis) over the port's own
machinery, on the CPU: every case of tests/test_analysis_checker.py and
the checker case of tests/test_maintenance.py, run on the port's
scheduler, scenarios and classes at repro's budgets; the plan cache
scenario over the real PlanCache (and the seeded DoubleCapturePlanCache
it must flag); and the explorations held to repro's on the same
scenarios, strategies and seeds (the same schedules, step for step)."""

import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from repro.analysis import checker as jchecker
from repro.analysis import schedules as jschedules
from repro_torch.analysis.buggy import (DoubleCapturePlanCache,
                                        DoubleExecuteEngine,
                                        MutableSnapshotEngine)
from repro_torch.analysis.checker import (ENGINE_STALL, REFRESH_STALL,
                                          EngineScenario, JournalScenario,
                                          MaintenanceScenario,
                                          OverloadScenario,
                                          PlanCacheScenario, QualityScenario,
                                          RefreshScenario, StubIndex,
                                          StubPlans, TrackedCondition,
                                          explore)
from repro_torch.analysis.hooks import SyncHook, installed
from repro_torch.analysis.schedules import DFSStrategy, RandomStrategy

REPO = Path(__file__).resolve().parent.parent


# ----------------------------------------------------------- invariants
def test_refresh_dfs_invariants():
    rep = explore(RefreshScenario(n_threads=2),
                  DFSStrategy(max_preemptions=2), budget=150)
    assert rep.ok, rep.violations
    assert rep.runs >= 50
    assert rep.distinct == rep.runs          # DFS never repeats a schedule


def test_refresh_lockfree_under_permanent_stalls():
    """A worker stalled mid-element (half-done state visible forever!)
    must not stop the survivors from finishing every chunk/group/flag."""
    rep = explore(RefreshScenario(n_threads=3),
                  RandomStrategy(seed=5, p_stall=0.3,
                                 stall_points=REFRESH_STALL),
                  budget=80)
    assert rep.ok, rep.violations
    assert rep.stalled_runs > 10


def test_journal_dfs_invariants():
    rep = explore(JournalScenario(), DFSStrategy(max_preemptions=2),
                  budget=150)
    assert rep.ok, rep.violations
    assert rep.runs >= 50


def test_journal_random_three_workers():
    rep = explore(JournalScenario(n_workers=3), RandomStrategy(seed=9),
                  budget=60)
    assert rep.ok, rep.violations


def test_engine_race_invariants():
    """Concurrent submit/add/flush/flush against the port's QueryEngine:
    exactly-once delivery, epoch-bound oracle results, snapshot
    immutability, GC correctness — across every explored interleaving."""
    rep = explore(EngineScenario(name="race", auto_compact=2),
                  RandomStrategy(seed=3), budget=80)
    assert rep.ok, rep.violations
    assert rep.runs == 80


def test_engine_lockfree_under_permanent_stalls():
    """A helper stalled mid-execution (owning a journal part) must not
    block completion: live clients force-steal and deliver everything
    BEFORE the schedule ends — no uncontrolled drain allowed."""
    rep = explore(EngineScenario(name="lf", lockfree=True),
                  RandomStrategy(seed=4, p_stall=0.35,
                                 stall_points=ENGINE_STALL),
                  budget=60)
    assert rep.ok, rep.violations
    assert rep.stalled_runs > 10


def test_engine_overload_invariants():
    """Admission shedding, batch-priority eviction, deadline expiry and
    the epoch-keyed result cache racing submits/add/flush: every future
    terminates exactly once, cache fills and hits match the oracle of
    the epoch in their key, and the counters conserve the terminal
    events."""
    rep = explore(OverloadScenario(name="overload"),
                  RandomStrategy(seed=6), budget=80)
    assert rep.ok, rep.violations
    assert rep.runs == 80


def test_engine_overload_under_permanent_stalls():
    rep = explore(OverloadScenario(name="overload.stall"),
                  RandomStrategy(seed=7, p_stall=0.3,
                                 stall_points=ENGINE_STALL),
                  budget=60)
    assert rep.ok, rep.violations
    assert rep.stalled_runs > 10


def test_regression_shed_future_never_also_delivered():
    """A batch future evicted by an interactive arrival is terminally
    failed — a later flush of the same queue must not ALSO deliver rows
    into it."""
    from repro_torch.serve.engine import (AdmissionError, EngineConfig,
                                          QueryEngine)
    rng = np.random.RandomState(3)
    eng = QueryEngine(StubIndex(rng.randn(6, 8).astype(np.float32)),
                      EngineConfig(workers=0, max_batch=4, max_pending=2))
    eng.plans = StubPlans()
    q = rng.randn(1, 8).astype(np.float32)
    fb = eng.submit(q, k=1, priority="batch")
    fb2 = eng.submit(q, k=1, priority="batch")
    fi = eng.submit(rng.randn(2, 8).astype(np.float32), k=1)  # evicts both
    assert fb.done() and fb2.done()
    eng.flush()
    for f in (fb, fb2):
        with pytest.raises(AdmissionError):
            f.result(timeout=1)
        assert not f._filled.any()           # no rows ever landed
    d, i = fi.result(timeout=5)
    assert d.shape == (2,)
    assert eng.stats()["overload"]["evicted_batch"] == 2


def test_regression_cache_hit_serves_submit_time_epoch():
    from repro_torch.serve.engine import EngineConfig, QueryEngine
    rng = np.random.RandomState(4)
    base = rng.randn(6, 8).astype(np.float32)
    eng = QueryEngine(StubIndex(base),
                      EngineConfig(workers=0, max_batch=4,
                                   cache_entries=8))
    eng.plans = StubPlans()
    q = rng.randn(1, 8).astype(np.float32)
    d0, i0 = eng.submit(q, k=2).result(timeout=5)
    d1, i1 = eng.submit(q, k=2).result(timeout=5)      # epoch-0 hit
    np.testing.assert_array_equal(d1, d0)
    np.testing.assert_array_equal(i1, i0)
    assert eng.stats()["result_cache"]["hits"] == 1
    eng.add(rng.randn(2, 8).astype(np.float32))        # epoch 1
    eng.submit(q, k=2).result(timeout=5)               # key differs: miss
    st = eng.stats()["result_cache"]
    assert st["hits"] == 1 and st["misses"] == 2


def test_dfs_exploration_is_deterministic():
    a = explore(RefreshScenario(n_threads=2),
                DFSStrategy(max_preemptions=1), budget=60)
    b = explore(RefreshScenario(n_threads=2),
                DFSStrategy(max_preemptions=1), budget=60)
    assert a.ok and b.ok
    assert (a.runs, a.distinct, a.steps) == (b.runs, b.distinct, b.steps)


# ------------------------------------------------- seeded-bug meta-tests
def test_catches_double_execute():
    rep = explore(EngineScenario(name="bug.double", lockfree=True,
                                 engine_cls=DoubleExecuteEngine),
                  RandomStrategy(seed=11), budget=200, stop_after=1)
    assert not rep.ok
    assert any("delivered 2 times" in v for v in rep.violations), \
        rep.violations
    assert rep.runs <= 200


def test_catches_mutable_snapshot():
    rep = explore(EngineScenario(name="bug.mut",
                                 engine_cls=MutableSnapshotEngine),
                  RandomStrategy(seed=12), budget=50, stop_after=2)
    assert not rep.ok
    assert any("mutated after publish" in v for v in rep.violations), \
        rep.violations
    assert rep.runs <= 50


@pytest.mark.parametrize("n_getters", [2, 3, 4])
def test_catches_double_capture(n_getters):
    """Retiring a key's capture under one hold of the cache lock and
    storing its plan under a second (PlanCache.get before its repair)
    must be caught as two plans made for one key."""
    rep = explore(PlanCacheScenario(name="bug.capture", n_getters=n_getters,
                                    cache_cls=DoubleCapturePlanCache),
                  RandomStrategy(seed=13), budget=60, stop_after=1)
    assert not rep.ok
    assert any("2 plans made for key" in v for v in rep.violations), \
        rep.violations


# ------------------------------------------------------ regression tests
def test_regression_no_blocking_work_under_cv():
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        rep = explore(EngineScenario(name="durable", journal_dir=tmp,
                                     auto_compact=3),
                      RandomStrategy(seed=6), budget=25)
    assert rep.ok, rep.violations


def test_regression_flush_rescues_helper_orphan():
    from repro_torch.serve.engine import HELPER_ID, EngineConfig, QueryEngine
    rng = np.random.RandomState(0)
    eng = QueryEngine(StubIndex(rng.randn(5, 8).astype(np.float32)),
                      EngineConfig(workers=0, linger_ms=0.0,
                                   help_after_ms=0.0))
    eng.plans = StubPlans()
    fut = eng.submit(rng.randn(1, 8).astype(np.float32), k=1)
    eng._form_and_register()
    pid = eng._journal.acquire(HELPER_ID)   # a helper claims the part
    assert pid is not None                  # ... then stalls forever
    eng.flush()                             # another helper must rescue
    assert fut.done()
    d, i = fut.result(timeout=0)
    assert i.shape == (1,)


def test_regression_real_index_lock_discipline():
    """The lock-discipline invariant against the port's real FreshIndex
    (no stubs): journal persistence and delta materialization stay
    outside the engine locks through add/submit/flush."""
    import tempfile
    from repro_torch.api import FreshIndex
    from repro_torch.serve.engine import EngineConfig

    events = []

    class Recorder(SyncHook):
        def __init__(self):
            self.cv = None

        def observe(self, name, obj):
            if name in ("journal.persist", "index.delta_cat"):
                events.append((name, self.cv.held()))

    rng = np.random.RandomState(1)
    ix = FreshIndex.build(rng.randn(8, 16).astype(np.float32),
                          device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        eng = ix.engine(EngineConfig(
            workers=0, journal_path=str(Path(tmp) / "j.json")))
        rec = Recorder()
        rec.cv = eng._cv = TrackedCondition(eng._cv)
        with installed(rec):
            fut = eng.submit(rng.randn(1, 16).astype(np.float32), k=2)
            eng.add(rng.randn(2, 16).astype(np.float32))
            eng.flush()
            fut.result(timeout=5)
    assert events, "expected persist/delta_cat events to fire"
    under_cv = [n for n, held in events if held]
    assert not under_cv, f"blocking work under _cv: {under_cv}"


def test_regression_flush_retires_batchless_journal_parts():
    from repro_torch.serve.engine import EngineConfig, QueryEngine
    rng = np.random.RandomState(3)
    eng = QueryEngine(StubIndex(rng.randn(5, 8).astype(np.float32)),
                      EngineConfig(workers=0, help_after_ms=0.0))
    eng.plans = StubPlans()
    eng._journal.add_part()                 # a part nobody holds a batch for
    done = threading.Event()
    t = threading.Thread(target=lambda: (eng.flush(), done.set()),
                         daemon=True)
    t.start()
    t.join(timeout=10)
    assert done.is_set(), "flush() livelocked on a batchless journal part"
    assert eng._journal.all_done()
    fut = eng.submit(rng.randn(1, 8).astype(np.float32), k=1)
    d, i = fut.result(timeout=10)
    assert i.shape == (1,)


def test_regression_restart_recovers_crashed_journal():
    import tempfile
    from repro_torch.runtime.journal import WorkJournal
    from repro_torch.serve.engine import EngineConfig, QueryEngine
    rng = np.random.RandomState(4)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "j.json")
        crashed = WorkJournal(path, n_parts=0, autopersist=False)
        crashed.add_part()                  # dispatched, in flight
        crashed.add_part()                  # dispatched, never started
        crashed.acquire(0)
        crashed.persist()
        eng = QueryEngine(StubIndex(rng.randn(5, 8).astype(np.float32)),
                          EngineConfig(workers=0, help_after_ms=0.0,
                                       journal_path=path))
        eng.plans = StubPlans()
        done = threading.Event()
        t = threading.Thread(target=lambda: (eng.flush(), done.set()),
                             daemon=True)
        t.start()
        t.join(timeout=10)
        assert done.is_set(), "flush() livelocked on crash-reloaded parts"
        fut = eng.submit(rng.randn(1, 8).astype(np.float32), k=1)
        d, i = fut.result(timeout=10)
        assert i.shape == (1,)
        eng.close()
        reloaded = WorkJournal(path, n_parts=0)
        assert reloaded.n_parts == 3
        assert all(reloaded.is_done(p) for p in range(3))


def test_regression_deferred_persist_writes_capture_time_state():
    import tempfile
    from repro_torch.runtime.journal import WorkJournal
    in_write, resume = threading.Event(), threading.Event()

    class StallWrite(SyncHook):
        def observe(self, name, obj):
            if name == "journal.persist":
                in_write.set()
                resume.wait(10)

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "j.json")
        j = WorkJournal(path, n_parts=0, autopersist=False)
        for _ in range(3):
            j.add_part()
        j.acquire(0)
        j.mark_done(0)
        with installed(StallWrite()):
            t = threading.Thread(target=j.persist, daemon=True)
            t.start()
            assert in_write.wait(10)
            j.prune_done()
            j.acquire(1)
            j.mark_done(1)
            resume.set()
            t.join(10)
        got = WorkJournal(path, n_parts=0)
    assert got._base == 0 and got.n_parts == 3
    assert got.is_done(0) and not got.is_done(1) and not got.is_done(2)


def test_checker_maintenance_scenario_quick():
    """tests/test_maintenance.py's checker case on the port."""
    rep = explore(MaintenanceScenario(), RandomStrategy(seed=3), budget=12)
    assert rep.runs == 12
    assert rep.ok, rep.violations


# ------------------------------------------------------------ plan cache
@pytest.mark.parametrize("n_getters", [2, 3, 4])
def test_plan_cache_scenario_makes_one_plan_a_key(n_getters):
    """The repaired PlanCache under racing misses of one key, another
    key, a late helper on an old epoch and a publish dropping that
    epoch: one plan a key, every call counted, nothing of the dropped
    epoch kept, every caller served its own key's plan, rows equal to
    the facade's search."""
    rep = explore(PlanCacheScenario(n_getters=n_getters),
                  RandomStrategy(seed=20 + n_getters), budget=40)
    assert rep.ok, rep.violations
    assert rep.runs == 40 and rep.distinct > 20


def test_plan_cache_scenario_validates_its_getters():
    with pytest.raises(ValueError):
        PlanCacheScenario(n_getters=5)


# -------------------------------------------------------- parity to repro
_PARITY = {
    "refresh.dfs": lambda m: (m.RefreshScenario(n_threads=2),
                              DFS(m, 2), 60),
    "refresh.stall": lambda m: (m.RefreshScenario(n_threads=3),
                                RND(m, 1, p_stall=0.25,
                                    stall_points=m.REFRESH_STALL), 40),
    "journal.dfs": lambda m: (m.JournalScenario(), DFS(m, 2), 60),
    "journal.random": lambda m: (m.JournalScenario(n_workers=3),
                                 RND(m, 2), 30),
    "engine.race": lambda m: (m.EngineScenario(name="engine.race",
                                               auto_compact=2),
                              RND(m, 3), 20),
    "engine.maint": lambda m: (m.MaintenanceScenario(), RND(m, 7), 12),
}


def DFS(m, p):
    sched = jschedules if m is jchecker else sys.modules[
        "repro_torch.analysis.schedules"]
    return sched.DFSStrategy(max_preemptions=p)


def RND(m, seed, **kw):
    sched = jschedules if m is jchecker else sys.modules[
        "repro_torch.analysis.schedules"]
    return sched.RandomStrategy(seed=seed, **kw)


@pytest.mark.parametrize("name", sorted(_PARITY))
def test_explorations_equal_repros(name):
    """The same scenario under the same strategy and seed walks the same
    schedules on both packages: runs, distinct interleavings and steps
    equal, and both clean."""
    import repro_torch.analysis.checker as tchecker
    got = []
    for m in (jchecker, tchecker):
        scenario, strategy, budget = _PARITY[name](m)
        rep = m.explore(scenario, strategy, budget=budget)
        assert rep.ok, rep.violations
        got.append((rep.runs, rep.distinct, rep.steps, rep.stalled_runs))
    assert got[0] == got[1]


def test_engine_scenarios_cover_quality_tiers():
    rep = explore(QualityScenario(), RandomStrategy(seed=8), budget=16)
    assert rep.ok, rep.violations


# ------------------------------------------------------------------- CLI
@pytest.mark.parametrize("args", [["--budget", "60", "--scenario",
                                   "journal"],
                                  ["--budget", "40"]])
def test_checker_cli_quick(args):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.checker", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stdout + r.stderr
    assert "distinct" in r.stdout and "0 scenario(s) with violations" \
        in r.stdout


def test_checker_cli_unknown_scenario():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.checker",
         "--budget", "10", "--scenario", "nonesuch"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    assert r.returncode == 2 and "no portfolio entry" in r.stdout
