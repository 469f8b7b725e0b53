"""Schedule-exploring race checker: scenarios + machine-verified invariants.

The port's copy of `repro.analysis.checker`, over the port's machinery.
Each SCENARIO spins up the REAL concurrency machinery — `RefreshRun`
workers (core/refresh.py), a `WorkJournal` with helping (runtime/
journal.py), a `QueryEngine` with submit/add/flush/helping races
(serve/engine.py), a `PlanCache` with racing captures (serve/
plan_cache.py) — under the controlled scheduler (analysis/schedules),
then checks the INVARIANT CATALOG after every interleaving:

  exactly-once    every journal part's logical effect lands exactly once
                  (physical re-execution by helpers is allowed — that is
                  the paper's at-least-once traversing property — but
                  each future row is DELIVERED exactly once and counters
                  never double-count);
  bit-identity    a future bound to epoch e returns exactly the oracle
                  answer over e's data, and byte-identical results for
                  the same (client, epoch) across every schedule;
  immutability    a published Snapshot never changes after publish
                  (byte fingerprints at publish vs. end of run);
  lock-freedom    with one thread PERMANENTLY STALLED at an adversarial
                  point (stronger than the crash injectors: its
                  half-done state stays visible), the remaining threads
                  still finish everything — no deadlock, no livelock;
  lock discipline blocking work (journal file persistence, host->device
                  delta transfer) never runs while the engine's _cv or
                  _wlock is held;
  overload        a shed or deadline-expired future terminates exactly
                  once — never both shed AND delivered, never stranded —
                  and a result-cache entry never serves rows from a
                  different epoch than its key (hits == the oracle over
                  the key epoch's data);
  lifecycle       a deleted series never resurrects (every delivered
                  result equals the tombstone-aware oracle over its
                  bound epoch's view; dead ids never appear), each
                  tombstone is physically dropped by compaction exactly
                  once, and identical tombstone views yield
                  byte-identical answers across schedules;
  quality         with latency tiers active, an exact-tier future is
                  always answered by the exact program and an
                  approx-tier future by its tier's program — the stub
                  approx plan truncates the candidate set so a plan- or
                  result-cache key collision between tiers changes
                  delivered bytes and cannot hide — and every cache hit
                  serves rows from the hitting future's own (tier,
                  epoch).
  one capture     a plan cache makes at most one plan per key and epoch
                  under racing misses and a publish that drops an epoch;
                  hits + misses count every call, no plan of a dropped
                  epoch is kept, and every caller receives a plan of its
                  own key whose rows equal the facade's search.

Engine scenarios run the real QueryEngine over a stub index + stub plan
cache (pure-numpy brute force): every schedule then costs milliseconds,
which is what makes >=10k interleavings tractable, and the invariants
target exactly the machinery the stub does NOT replace — snapshots,
batching, journal helping, future delivery.  The stubs hand the engine
numpy arrays where the port's index holds tensors: the engine only
passes a snapshot's arrays on to its plans, and the stub plans read
numpy.  Refresh and journal scenarios are stub-free, and so is the plan
cache scenario (a real `PlanCache` over a real port index: eager plans
on the CPU, CUDA graph captures on the card).

CLI::

    python -m repro_torch.analysis.checker                 # full (>=10k runs)
    python -m repro_torch.analysis.checker --budget 400    # CI quick gate
    python -m repro_torch.analysis.checker --scenario refresh.dfs --budget 50

Exit status 0 iff every scenario holds every invariant.
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .hooks import SyncHook, installed, observe
from .schedules import (ControlledScheduler, DFSStrategy, RandomStrategy,
                        RunResult, ScheduleLivelock, SchedulerHang, Strategy)

__all__ = ["ExploreReport", "PlanCacheScenario", "Scenario",
           "StubCalibration", "StubIndex", "StubPlans", "QualityStubPlans",
           "TrackedCondition", "TrackedLock", "engine_scenario", "explore",
           "journal_scenario", "main", "maintenance_scenario",
           "make_portfolio", "overload_scenario", "plan_cache_scenario",
           "quality_scenario", "refresh_scenario", "snapshot_fingerprint",
           "stub_topk", "stub_topk_alive"]


# ------------------------------------------------------------------ stubs
class StubConfig:
    """The IndexConfig fields QueryEngine reads when resolving knobs."""
    round_leaves = 8
    znorm = False
    pq_budget = None


class _StubCore:
    """Stands in for FlatIndex: the fields Snapshot.plan_sig reads, plus
    the stable row ids and (for tombstone-masked views) an alive mask —
    the stub spelling of the real core's sentinel-norm masking."""

    __slots__ = ("series", "n_leaves", "ids", "alive")

    def __init__(self, series: np.ndarray, ids: Optional[np.ndarray] = None,
                 alive: Optional[np.ndarray] = None):
        self.series = series
        self.n_leaves = 1
        self.ids = (np.arange(series.shape[0], dtype=np.int64)
                    if ids is None else np.asarray(ids, np.int64))
        self.alive = None if alive is None else np.asarray(alive, bool)


class StubIndex:
    """A FreshIndex look-alike whose search is pure-numpy brute force.

    Mirrors the facade's concurrency-relevant contract exactly: add()
    buffers immutable delta batches, delta_cat materializes lazily (and
    emits the same `index.delta_cat` observe as the real facade — the
    lock-discipline invariant watches for it), search_view() is the
    tombstone-masked read surface the engine captures (a masked core
    VIEW plus a delta alive-mask plus the delta id offset — the stored
    arrays are never touched), prepare/commit_compact split heavy work
    from the O(1) swap, ids are stable and never reused, and every
    published array is replaced, never mutated.  `dropped_log` records
    the ids each compaction physically removed so the exactly-once-drop
    invariant can be machine-checked."""

    def __init__(self, base: np.ndarray):
        base = np.asarray(base, np.float32)
        self._core = _StubCore(base)
        self._delta: List[np.ndarray] = []
        self._dcat: Optional[np.ndarray] = None
        self._n_base = base.shape[0]
        self._next_id = base.shape[0]
        self._delta_id0 = base.shape[0]
        self._tombstones: set = set()
        self._ttl: Dict[int, float] = {}
        self._first_tombstone_at: Optional[float] = None
        self.dropped_log: List[Tuple[int, ...]] = []
        self.config = StubConfig()
        self.mesh = None
        self.mesh_axis = "data"
        self._alias: dict = {}          # no update() renames
        self._calib = None              # StubCalibration for tier tests

    @property
    def index(self):
        return self._core

    @property
    def device(self):
        """The device the engine's PlanCache is made for (the stub's
        arrays live on the host; the engine swaps in StubPlans)."""
        import torch
        return torch.device("cpu")

    @property
    def n_series(self) -> int:
        return self._n_base + self.n_pending - len(self._tombstones)

    @property
    def n_pending(self) -> int:
        return sum(b.shape[0] for b in self._delta)

    @property
    def n_deleted(self) -> int:
        return len(self._tombstones)

    @property
    def n_ttl(self) -> int:
        return len(self._ttl)

    @property
    def tombstone_age_s(self) -> Optional[float]:
        if self._first_tombstone_at is None:
            return None
        return time.monotonic() - self._first_tombstone_at

    @property
    def series_len(self) -> int:
        return self._core.series.shape[1]

    @property
    def delta_cat(self) -> Optional[np.ndarray]:
        if not self._delta:
            return None
        if self._dcat is None:
            observe("index.delta_cat", self)
            self._dcat = np.concatenate(self._delta, axis=0)
        return self._dcat

    @property
    def delta_rows(self) -> Optional[np.ndarray]:
        """The pending rows the snapshot's plans scan (the real facade
        stores them summarized on the device; the stub plans read them
        as they are)."""
        return self.delta_cat

    def shard_view(self):
        """The stub is never sharded."""
        return None

    @property
    def calibration(self):
        """The installed stub calibration table (None = uncalibrated),
        mirroring FreshIndex.calibration for the engine's tier stats."""
        return self._calib

    def search_knobs(self):
        """FreshIndex.search_knobs' contract over the stub: no autotune
        table is ever installed here, so the chain is just StubConfig
        fields over the static defaults (the engine reads the resolved
        TuneConfig when it builds its Knobs)."""
        from repro_torch.kernels.autotune import resolve_knobs
        return resolve_knobs(self.config, None)

    def resolve_stop_rule(self, mode: str, *, k: int,
                          recall_target: float = 0.95,
                          stop_eps: Optional[float] = None,
                          max_leaves: Optional[int] = None):
        """FreshIndex.resolve_stop_rule's contract over the stub table:
        exact -> EXACT, explicit knobs -> a StopRule, otherwise a table
        lookup that raises for uncalibrated (k, target) pairs — which is
        what lets the REAL `QueryEngine._tier_for` run unmodified in the
        quality scenario."""
        from repro_torch.quality.stop_rules import EXACT, StopRule
        if mode == "exact":
            return EXACT
        if stop_eps is not None or max_leaves is not None:
            return StopRule(eps=stop_eps if stop_eps is not None else 0.0,
                            max_leaves=max_leaves)
        entry = None if self._calib is None \
            else self._calib.lookup(k, recall_target)
        if entry is None:
            raise ValueError(f"no stub calibration entry for (k={k}, "
                             f"recall_target={recall_target})")
        return entry.rule

    def search_view(self):
        """(core_view, delta, delta_alive, delta_id0) — the facade's
        tombstone-masked read surface.  The masked core is a NEW object
        over the same series array (replace, never mutate)."""
        core = self._core
        delta = self.delta_cat
        alive = None
        if self._tombstones:
            dead_ids = np.fromiter(self._tombstones, np.int64)
            cdead = np.isin(core.ids, dead_ids)
            if cdead.any():
                core = _StubCore(core.series, ids=core.ids, alive=~cdead)
            if delta is not None:
                did = self._delta_id0 + np.arange(delta.shape[0],
                                                  dtype=np.int64)
                da = ~np.isin(did, dead_ids)
                if not da.all():
                    alive = da
        return core, delta, alive, self._delta_id0

    def add(self, batch, *, ttl_s: Optional[float] = None) -> "StubIndex":
        b = np.array(batch, np.float32)
        if b.ndim == 1:
            b = b[None]
        if b.ndim != 2 or b.shape[1] != self.series_len:
            raise ValueError(f"batch must be (m, {self.series_len})")
        if ttl_s is not None:
            if ttl_s <= 0:
                raise ValueError("ttl_s must be > 0")
            first = self._delta_id0 + self.n_pending
            ddl = time.monotonic() + ttl_s
            for sid in range(first, first + b.shape[0]):
                self._ttl[sid] = ddl
        self._delta.append(b)
        self._next_id += b.shape[0]
        self._dcat = None
        return self

    def delete(self, ids) -> int:
        if isinstance(ids, (int, np.integer)):
            ids = [ids]
        live = set(self._core.ids.tolist())
        live.update(range(self._delta_id0, self._delta_id0 + self.n_pending))
        new = 0
        for sid in ids:
            sid = int(sid)
            if sid < 0 or sid >= self._next_id:
                raise ValueError(f"unknown series id {sid}")
            if sid in self._tombstones or sid not in live:
                continue            # already deleted / already dropped
            self._tombstones.add(sid)
            self._ttl.pop(sid, None)
            if self._first_tombstone_at is None:
                self._first_tombstone_at = time.monotonic()
            new += 1
        return new

    def expire_ttl(self, now: Optional[float] = None) -> int:
        now = time.monotonic() if now is None else now
        expired = [sid for sid, ddl in self._ttl.items() if ddl <= now]
        return self.delete(expired) if expired else 0

    def prepare_compact(self):
        drops = frozenset(self._tombstones)
        if not self._delta and not drops:
            return None
        dead_ids = np.fromiter(drops, np.int64) if drops \
            else np.empty(0, np.int64)
        ckeep = ~np.isin(self._core.ids, dead_ids)
        n_rows = self.n_pending
        if self._delta:
            delta = np.concatenate(self._delta, axis=0)
            did = self._delta_id0 + np.arange(n_rows, dtype=np.int64)
            dkeep = ~np.isin(did, dead_ids)
            merged = np.concatenate([self._core.series[ckeep],
                                     delta[dkeep]], axis=0)
            mids = np.concatenate([self._core.ids[ckeep], did[dkeep]])
        else:
            merged = self._core.series[ckeep]
            mids = self._core.ids[ckeep]
        # delete() only tombstones LIVE ids, so every tombstone maps to
        # exactly one physically removed row (core or delta)
        dropped = tuple(sorted(drops))
        return (merged, mids, n_rows, len(self._delta), drops, dropped)

    def commit_compact(self, token) -> "StubIndex":
        if token is None:
            return self
        merged, mids, n_rows, n_batches, drops, dropped = token
        if (len(self._delta) != n_batches
                or sum(b.shape[0] for b in self._delta) != n_rows):
            raise RuntimeError("delta changed between prepare and commit")
        if frozenset(self._tombstones) != drops:
            raise RuntimeError("tombstones changed between prepare and "
                               "commit")
        self._core = _StubCore(merged, ids=mids)
        self._n_base = merged.shape[0]
        self._delta = []
        self._dcat = None
        self._delta_id0 = self._next_id
        self._tombstones = set()
        self._first_tombstone_at = None
        if dropped:
            self.dropped_log.append(dropped)
        return self


def stub_topk(q: np.ndarray, data: np.ndarray, k: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic brute-force top-k (squared L2, stable ties)."""
    d = ((q[:, None, :] - data[None, :, :]) ** 2).sum(-1)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(d, order, axis=1).astype(np.float32),
            order.astype(np.int32))


def stub_topk_alive(q: np.ndarray, data: np.ndarray,
                    ids: Optional[np.ndarray], alive: Optional[np.ndarray],
                    k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Tombstone-aware brute-force oracle: a dead row can never win (its
    distance is masked to +inf before selection), and a dead row that is
    selected anyway — only possible when fewer than k rows are alive —
    reports (inf, -1).  With `ids`/`alive` None this reduces bit-exactly
    to `stub_topk` (positional ids), which is what keeps the mask-free
    engine scenarios byte-stable across this addition."""
    d = ((q[:, None, :] - data[None, :, :]) ** 2).sum(-1)
    if alive is not None:
        d = np.where(alive[None, :], d, np.inf)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    dd = np.take_along_axis(d, order, axis=1).astype(np.float32)
    ii = (order if ids is None else ids[order]).astype(np.int32)
    if alive is not None:
        ii = np.where(alive[order], ii, -1).astype(np.int32)
    return dd, ii


class _StubPlan:
    """A plan of one snapshot, as the port's CompiledPlan: `run(queries,
    token=...)` -> (dist, ids, rounds) numpy rows."""

    __slots__ = ("snap", "k")

    def __init__(self, snap, k: int):
        self.snap = snap
        self.k = k

    def run(self, queries, token=None):
        snap = self.snap
        q = np.asarray(queries, np.float32)
        core = snap.core
        n_core = core.series.shape[0]
        data = [np.asarray(core.series)]
        ids = [np.asarray(core.ids, np.int64)]
        alive = [np.ones(n_core, bool) if core.alive is None
                 else np.asarray(core.alive, bool)]
        if snap.delta_rows is not None:
            m = snap.delta_rows.shape[0]
            data.append(np.asarray(snap.delta_rows))
            ids.append(snap.n_base + np.arange(m, dtype=np.int64))
            da = getattr(snap, "delta_alive", None)
            alive.append(np.ones(m, bool) if da is None
                         else np.asarray(da, bool))
        a = np.concatenate(alive)
        d, i = stub_topk_alive(q, np.concatenate(data, axis=0),
                               np.concatenate(ids),
                               None if a.all() else a, self.k)
        return d, i, 1


class StubPlans:
    """PlanCache stand-in: no capture, pure-numpy plans."""
    donate = False

    def get(self, snap, bucket_q: int, k: int, knobs) -> _StubPlan:
        return _StubPlan(snap, k)

    def drop_epochs(self, epochs) -> list:
        return []

    def stats(self) -> dict:
        return {"hits": 0, "misses": 0, "size": 0, "donate": False,
                "sharded_traces": 0}


class _StubCalibEntry:
    """One stub CalibrationEntry: just the fields _tier_for reads."""

    __slots__ = ("rule", "recall")

    def __init__(self, rule, recall: float):
        self.rule = rule
        self.recall = recall


class StubCalibration:
    """CalibrationTable stand-in: one (k, target) -> StopRule entry."""

    def __init__(self, k: int, target: float, max_leaves: int,
                 recall: float = 1.0):
        from repro_torch.quality.stop_rules import StopRule
        self._key = (int(k), round(float(target), 6))
        self._entry = _StubCalibEntry(StopRule(max_leaves=max_leaves),
                                      recall)

    def lookup(self, k: int, target: float):
        if (int(k), round(float(target), 6)) == self._key:
            return self._entry
        return None


class _QualityStubPlan(_StubPlan):
    """Tier-sensitive stub plan: with `stop_leaves` set (an approx
    tier's knobs) only the first `stop_leaves` CORE rows are candidates
    — the stub spelling of 'visit fewer leaves' — while the delta scan
    stays exact, mirroring the real stop-rule contract.  Exact and
    approx therefore return DIFFERENT bytes whenever a true neighbor
    lives past the truncation, which is what makes a plan/cache key
    collision between tiers machine-detectable."""

    __slots__ = ("stop_leaves",)

    def __init__(self, snap, k: int, stop_leaves: Optional[int]):
        super().__init__(snap, k)
        self.stop_leaves = stop_leaves

    def run(self, queries, token=None):
        snap = self.snap
        q = np.asarray(queries, np.float32)
        core = snap.core
        n_core = core.series.shape[0]
        m = n_core if self.stop_leaves is None \
            else min(int(self.stop_leaves), n_core)
        data = [np.asarray(core.series)[:m]]
        ids = [np.asarray(core.ids, np.int64)[:m]]
        alive = [np.ones(m, bool) if core.alive is None
                 else np.asarray(core.alive, bool)[:m]]
        if snap.delta_rows is not None:
            nd = snap.delta_rows.shape[0]
            data.append(np.asarray(snap.delta_rows))
            ids.append(snap.n_base + np.arange(nd, dtype=np.int64))
            da = getattr(snap, "delta_alive", None)
            alive.append(np.ones(nd, bool) if da is None
                         else np.asarray(da, bool))
        a = np.concatenate(alive)
        d, i = stub_topk_alive(q, np.concatenate(data, axis=0),
                               np.concatenate(ids),
                               None if a.all() else a, self.k)
        return d, i, 1


class QualityStubPlans(StubPlans):
    """PlanCache stand-in that honors the knobs' stop rule."""

    def get(self, snap, bucket_q: int, k: int, knobs) -> _StubPlan:
        return _QualityStubPlan(snap, k, getattr(knobs, "stop_leaves", None))


# ------------------------------------------------- lock-discipline probes
class TrackedCondition:
    """Wraps a threading.Condition, tracking per-thread hold depth so the
    lock-discipline invariant can ask `held()` from observe callbacks."""

    def __init__(self, cond):
        self._c = cond
        self._depth: Dict[int, int] = {}

    def __enter__(self):
        self._c.__enter__()
        i = threading.get_ident()
        self._depth[i] = self._depth.get(i, 0) + 1
        return self

    def __exit__(self, *exc):
        i = threading.get_ident()
        self._depth[i] -= 1
        if not self._depth[i]:
            del self._depth[i]
        return self._c.__exit__(*exc)

    def wait(self, timeout=None):
        return self._c.wait(timeout)

    def notify(self, n=1):
        self._c.notify(n)

    def notify_all(self):
        self._c.notify_all()

    def held(self) -> bool:
        return self._depth.get(threading.get_ident(), 0) > 0


class TrackedLock:
    """Same for a plain Lock used as a context manager."""

    def __init__(self, lock):
        self._l = lock
        self._depth: Dict[int, int] = {}

    def __enter__(self):
        self._l.__enter__()
        i = threading.get_ident()
        self._depth[i] = self._depth.get(i, 0) + 1
        return self

    def __exit__(self, *exc):
        i = threading.get_ident()
        self._depth[i] -= 1
        if not self._depth[i]:
            del self._depth[i]
        return self._l.__exit__(*exc)

    def held(self) -> bool:
        return self._depth.get(threading.get_ident(), 0) > 0


class _ObserveForwarder(SyncHook):
    """Forwards observe() events to a callback without any parking —
    installed around scenario.finish() so the uncontrolled drain still
    feeds the invariant observers."""

    def __init__(self, fn: Callable[[str, Any], None]):
        self._fn = fn

    def observe(self, name: str, obj: Any) -> None:
        self._fn(name, obj)


def snapshot_fingerprint(snap) -> Tuple:
    """Byte-level identity of a published Snapshot (immutability check).
    Covers the tombstone view too: the core alive mask and the delta
    alive mask are part of what a bound batch must keep seeing."""
    core = np.asarray(snap.core.series)
    delta = (None if snap.delta_rows is None
             else np.asarray(snap.delta_rows).tobytes())
    calive = getattr(snap.core, "alive", None)
    dalive = getattr(snap, "delta_alive", None)
    return (snap.epoch, core.tobytes(), delta, snap.n_base, snap.n_total,
            int(snap.core.n_leaves),
            None if calive is None else np.asarray(calive).tobytes(),
            None if dalive is None else np.asarray(dalive).tobytes())


# -------------------------------------------------------------- scenarios
class Scenario:
    """One checkable concurrency scenario; carries cross-run state for
    the bit-identity-across-schedules invariant."""

    name = "scenario"
    park_on: Any = None

    def setup(self) -> Any:
        raise NotImplementedError

    def threads(self, ctx) -> List[Tuple[str, Callable[[], None]]]:
        raise NotImplementedError

    def observer(self, ctx) -> Optional[Callable[[str, Any], None]]:
        return None

    def finish(self, ctx, result: RunResult) -> None:
        """Uncontrolled post-run drain (runs on the exploring thread)."""

    def check(self, ctx, result: RunResult) -> List[str]:
        """Return invariant-violation descriptions (empty = all green)."""
        raise NotImplementedError


REFRESH_PARK = ("refresh.fai", "refresh.elem", "refresh.elem.pre_done",
                "refresh.group.pre_done", "refresh.chunk.pre_done",
                "refresh.help.scan")
REFRESH_STALL = ("refresh.elem.pre_done", "refresh.group.pre_done",
                 "refresh.chunk.pre_done", "refresh.fai")


class RefreshScenario(Scenario):
    """2-3 RefreshRun workers over a tiny 3-level workload.

    Invariants: traversing property (every element applied >= once), the
    exactly-once LOGICAL effect (final results == oracle; payloads write
    deterministic values into disjoint slots), and — with a stalled
    worker — lock-free termination: all done flags set by the survivors
    alone."""

    def __init__(self, n_elements: int = 6, n_threads: int = 2,
                 require_completion: bool = True):
        self.name = "refresh"
        self.park_on = REFRESH_PARK
        self.n_elements = n_elements
        self.n_threads = n_threads
        self.require_completion = require_completion

    def setup(self):
        from repro_torch.core.refresh import RefreshRun
        out = np.full(self.n_elements, -1, np.int64)

        def payload(e: int, mode: str) -> None:
            out[e] = e * 7 + 1          # deterministic, disjoint slots

        rr = RefreshRun(self.n_elements, payload,
                        n_threads=self.n_threads, chunks=2,
                        groups_per_chunk=2, backoff_factor=0.0)
        return {"rr": rr, "out": out}

    def threads(self, ctx):
        rr = ctx["rr"]
        return [(f"w{t}", lambda t=t: rr._worker(t))
                for t in range(self.n_threads)]

    def check(self, ctx, result):
        from repro_torch.core.traverse import check_traversing_property
        rr, out = ctx["rr"], ctx["out"]
        v = []
        if self.require_completion and not rr.all_done():
            v.append(f"lock-freedom: parts unfinished with survivors done "
                     f"(stalled={result.stalled})")
        if rr.all_done():
            if not check_traversing_property(self.n_elements,
                                             rr.applied_log):
                v.append("traversing property: element never applied")
            oracle = np.arange(self.n_elements) * 7 + 1
            if not np.array_equal(out, oracle):
                v.append(f"exactly-once logical effect: {out} != {oracle}")
            if rr.applications.value < self.n_elements:
                v.append("applications under-counted")
        return v


JOURNAL_PARK = ("journal.acquire", "journal.acquire.claim",
                "journal.add_part", "journal.mark_done", "journal.steal",
                "journal.prune")


class JournalScenario(Scenario):
    """Two workers + a producer over a real WorkJournal: static parts,
    dynamic add_part growth, unconditional helping (the engine's
    force-steal path), and a prune at quiescence.

    Invariants: every part done, exactly-once logical effect (results ==
    oracle), helping/attempt stats never lost to pruning, pruned window
    fully released."""

    def __init__(self, n_static: int = 2, n_dynamic: int = 2,
                 n_workers: int = 2):
        self.name = "journal"
        self.park_on = JOURNAL_PARK
        self.n_static = n_static
        self.n_dynamic = n_dynamic
        self.n_workers = n_workers
        self.total = n_static + n_dynamic

    def setup(self):
        from repro_torch.runtime.journal import WorkJournal
        j = WorkJournal(None, n_parts=self.n_static)
        out = np.full(self.total, -1, np.int64)
        return {"j": j, "out": out}

    def _work(self, ctx, wid: int) -> None:
        j, out = ctx["j"], ctx["out"]
        while True:
            pid = j.acquire(wid)
            if pid is None:
                break
            out[pid] = pid * 13 + 3
            j.mark_done(pid)
        # helping phase: unconditional steal (the flush/force-help rule)
        for pid in j.unfinished():
            if j.is_done(pid):
                continue
            j.steal(pid, wid)
            out[pid] = pid * 13 + 3
            j.mark_done(pid)

    def _produce(self, ctx) -> None:
        j = ctx["j"]
        for _ in range(self.n_dynamic):
            j.add_part()
        self._work(ctx, wid=99)         # the producer helps too

    def threads(self, ctx):
        ts = [("prod", lambda: self._produce(ctx))]
        ts += [(f"w{t}", lambda t=t: self._work(ctx, t))
               for t in range(self.n_workers)]
        return ts

    def finish(self, ctx, result):
        ctx["j"].prune_done()           # quiescent: no racing executors

    def check(self, ctx, result):
        j, out = ctx["j"], ctx["out"]
        v = []
        if not j.all_done():
            v.append(f"unfinished parts {j.unfinished()} "
                     f"(stalled={result.stalled})")
            return v
        oracle = np.arange(self.total) * 13 + 3
        if not np.array_equal(out, oracle):
            v.append(f"exactly-once logical effect: {out} != {oracle}")
        st = j.stats()
        if st["n_parts"] != self.total:
            v.append(f"n_parts {st['n_parts']} != {self.total}")
        if st["attempts"] < self.total:
            v.append("attempts lost (pruning dropped stats?)")
        if not all(j.is_done(p) for p in range(self.total)):
            v.append("is_done lost completion state after prune")
        if j.parts:
            v.append("prune_done left a done prefix resident")
        return v


ENGINE_PARK = ("engine.submit", "engine.add", "engine.form",
               "engine.flush.help", "engine.execute.run",
               "engine.execute.deliver", "engine.help")
ENGINE_STALL = ("engine.execute.run", "engine.execute.deliver")


class EngineScenario(Scenario):
    """Real QueryEngine (workers=0) over a StubIndex: two submitting
    clients, a writer publishing epochs (optionally auto-compacting),
    and flushing helpers, all racing.

    Invariants: every future delivered exactly once per row and completed
    exactly once; results == oracle over the future's SUBMIT-TIME epoch
    data; byte-identical per (client, epoch) across schedules; published
    snapshots never mutate; snapshot GC keeps only live epochs; no
    blocking event (journal persist, delta materialize) under _cv/_wlock.

    `lockfree=True` turns the clients into help-until-everyone-done
    loops and requires every future to complete DURING the schedule (no
    uncontrolled drain) — the progress guarantee under permanent stalls.
    """

    def __init__(self, name: str = "engine", auto_compact: Optional[int]
                 = None, journal_dir: Optional[str] = None,
                 lockfree: bool = False,
                 engine_cls=None):
        self.name = name
        self.park_on = ENGINE_PARK
        self.auto_compact = auto_compact
        self.journal_dir = journal_dir
        self.lockfree = lockfree
        self.engine_cls = engine_cls
        self._identity: Dict[Tuple, Tuple[bytes, bytes]] = {}
        rng = np.random.RandomState(7)
        self.base = rng.randn(6, 8).astype(np.float32)
        self.q0 = rng.randn(2, 8).astype(np.float32)
        self.q1 = rng.randn(1, 8).astype(np.float32)
        self.extra = rng.randn(2, 8).astype(np.float32)

    def setup(self):
        from repro_torch.serve.engine import EngineConfig, QueryEngine
        cls = self.engine_cls or QueryEngine
        jpath = None
        if self.journal_dir is not None:
            import tempfile
            jpath = tempfile.mktemp(suffix=".json", dir=self.journal_dir)
        ix = StubIndex(self.base)
        eng = cls(ix, EngineConfig(
            workers=0, linger_ms=0.0, help_after_ms=0.0, max_batch=4,
            auto_compact_rows=self.auto_compact, journal_path=jpath))
        eng.plans = StubPlans()
        cv = TrackedCondition(eng._cv)
        wl = TrackedLock(eng._wlock)
        eng._cv = cv
        eng._wlock = wl
        ctx: Dict[str, Any] = {
            "eng": eng, "cv": cv, "wl": wl,
            "futs": [None, None],
            "pub": {0: self.base.copy()},
            "fps": [(eng._snapshots[0],
                     snapshot_fingerprint(eng._snapshots[0]))],
            "fills": {},                # (fut_id, src, n) -> count
            "completions": {},          # fut_id -> count
            "gc": [],
            "lock_violations": [],
        }
        return ctx

    def observer(self, ctx):
        cv, wl = ctx["cv"], ctx["wl"]

        def obs(name: str, obj: Any) -> None:
            # Lock discipline: journal file I/O must run outside BOTH
            # engine locks; delta materialization (host->device transfer)
            # is legal under the writer mutex — capture intentionally
            # serializes with writers — but never under the shared _cv.
            if name == "journal.persist" and (cv.held() or wl.held()):
                where = "_cv" if cv.held() else "_wlock"
                ctx["lock_violations"].append(f"{name} while {where} held")
            elif name == "index.delta_cat" and cv.held():
                ctx["lock_violations"].append(f"{name} while _cv held")
            elif name == "engine.publish":
                ctx["pub"][obj.epoch] = np.concatenate(
                    [np.asarray(obj.core.series)]
                    + ([np.asarray(obj.delta_rows)]
                       if obj.delta_rows is not None else []),
                    axis=0).copy()
                ctx["fps"].append((obj, snapshot_fingerprint(obj)))
            elif name == "engine.gc":
                ctx["gc"].extend(obj)
            elif name == "engine.future.fill":
                fut, src, n, completed = obj
                key = (id(fut), src, n)
                ctx["fills"][key] = ctx["fills"].get(key, 0) + 1
                if completed:
                    c = ctx["completions"]
                    c[id(fut)] = c.get(id(fut), 0) + 1
        return obs

    # ----------------------------------------------------------- threads
    def _client(self, ctx, i: int, q: np.ndarray, k: int) -> None:
        eng = ctx["eng"]
        ctx["futs"][i] = eng.submit(q, k=k)
        if self.lockfree:
            # help until EVERY submitted future is done: the progress
            # obligation of a live thread in the lock-freedom model
            while True:
                futs = list(ctx["futs"])
                if all(f is not None and f.done() for f in futs):
                    return
                eng.flush()

    def _writer(self, ctx) -> None:
        ctx["eng"].add(self.extra)

    def _flusher(self, ctx) -> None:
        ctx["eng"].flush()

    def threads(self, ctx):
        ts = [("c0", lambda: self._client(ctx, 0, self.q0, 2)),
              ("c1", lambda: self._client(ctx, 1, self.q1, 1)),
              ("flush", lambda: self._flusher(ctx))]
        if not self.lockfree:
            # a second racing executor: two concurrent flush() calls
            # force-steal each other's parts, exercising the idempotent
            # re-execution + is_done delivery guard
            ts.append(("flush2", lambda: self._flusher(ctx)))
            ts.append(("add", lambda: self._writer(ctx)))
        return ts

    def finish(self, ctx, result):
        if not self.lockfree:
            ctx["eng"].flush()          # uncontrolled drain

    # ------------------------------------------------------------ checks
    def check(self, ctx, result):
        eng = ctx["eng"]
        v = list(ctx["lock_violations"])
        futs = ctx["futs"]
        if any(f is None for f in futs):
            # a stalled client never submitted; nothing further to check
            return v
        for i, fut in enumerate(futs):
            if not fut.done():
                v.append(f"future c{i} incomplete "
                         f"(lockfree={self.lockfree}, "
                         f"stalled={result.stalled})")
                continue
            data = ctx["pub"].get(fut.epoch)
            if data is None:
                v.append(f"c{i} bound to unpublished epoch {fut.epoch}")
                continue
            q = self.q0 if i == 0 else self.q1
            d_exp, i_exp = stub_topk(q, data, fut.k)
            if not (np.array_equal(fut._d, d_exp)
                    and np.array_equal(fut._i, i_exp)):
                v.append(f"c{i} result != oracle for epoch {fut.epoch}")
            key = (i, fut.epoch, fut.k)
            sig = (fut._d.tobytes(), fut._i.tobytes())
            prev = self._identity.setdefault(key, sig)
            if prev != sig:
                v.append(f"bit-identity broken across schedules for "
                         f"(client={i}, epoch={fut.epoch})")
            if ctx["completions"].get(id(fut), 0) != 1:
                v.append(f"c{i} completed "
                         f"{ctx['completions'].get(id(fut), 0)} times")
        # exactly-once row delivery
        for (fid, src, n), count in ctx["fills"].items():
            if count != 1:
                v.append(f"rows [{src}:{src + n}] delivered {count} times")
        if all(f is not None and f.done() for f in futs):
            if eng._completed != len(futs):
                v.append(f"_completed={eng._completed} != {len(futs)}")
            if eng._batches:
                v.append(f"unfinished batches left: {list(eng._batches)}")
            if eng._pending:
                v.append("pending queries left after drain")
        # published snapshots never mutate
        for snap, fp in ctx["fps"]:
            if snapshot_fingerprint(snap) != fp:
                v.append(f"snapshot epoch {snap.epoch} mutated after "
                         f"publish")
        # GC'd epochs must be dead and must not resurrect
        for e in ctx["gc"]:
            if e in eng._snapshots:
                v.append(f"GC'd epoch {e} resurrected")
        # GC is piggybacked on delivery, so epochs published after the
        # last delivery may legitimately still be resident; what must
        # hold is that one explicit cycle collects exactly the dead set.
        with eng._cv:
            eng._gc_snapshots()
        live = {eng._epoch}
        live.update(p.epoch for p in eng._pending)
        live.update(b.epoch for b in eng._batches.values())
        extra = set(eng._snapshots) - live
        if extra:
            v.append(f"snapshot GC left dead epochs {sorted(extra)}")
        if eng._epoch not in eng._snapshots:
            v.append("GC collected the live published epoch")
        return v


OVERLOAD_PARK = ENGINE_PARK + ("engine.shed",)


class OverloadScenario(Scenario):
    """Real QueryEngine under admission pressure: a tiny max_pending
    budget, mixed interactive/batch priorities, deadlines, and the
    epoch-keyed result cache, with a writer racing epoch publishes.

    Invariants (the overload additions to the catalog):

    * TERMINATE-EXACTLY-ONCE — every future observed anywhere ends in
      exactly one terminal event: delivered-complete, OR failed
      (AdmissionError / DeadlineExceeded).  Never both shed AND
      delivered, never zero (a stranded caller), never double.
    * CACHE-EPOCH COHERENCE — every cache fill and every cache hit
      serves rows equal to the brute-force oracle over the data of the
      EPOCH IN ITS KEY; a hit's epoch always equals the future's bound
      epoch.  Cross-epoch contamination cannot hide.
    * counter conservation — engine shed/evicted/expired counters match
      the observed terminal failure events by type.
    * bit-identity across schedules for delivered hot-query results per
      (epoch, k) — a cache hit is indistinguishable from cold execution.
    * the same lock-discipline probes as EngineScenario.
    """

    def __init__(self, name: str = "overload",
                 max_pending: int = 3, cache_entries: int = 8):
        self.name = name
        self.park_on = OVERLOAD_PARK
        self.max_pending = max_pending
        self.cache_entries = cache_entries
        self._identity: Dict[Tuple, Tuple[bytes, bytes]] = {}
        rng = np.random.RandomState(11)
        self.base = rng.randn(6, 8).astype(np.float32)
        self.qh = rng.randn(1, 8).astype(np.float32)   # hot (cacheable)
        self.qb = rng.randn(2, 8).astype(np.float32)   # batch priority
        self.qd = rng.randn(1, 8).astype(np.float32)   # deadline-stamped
        self.extra = rng.randn(2, 8).astype(np.float32)

    def setup(self):
        from repro_torch.serve.engine import EngineConfig, QueryEngine
        ix = StubIndex(self.base)
        eng = QueryEngine(ix, EngineConfig(
            workers=0, linger_ms=0.0, help_after_ms=0.0, max_batch=4,
            max_pending=self.max_pending,
            cache_entries=self.cache_entries))
        eng.plans = StubPlans()
        cv = TrackedCondition(eng._cv)
        wl = TrackedLock(eng._wlock)
        eng._cv = cv
        eng._wlock = wl
        return {
            "eng": eng, "cv": cv, "wl": wl,
            "hot": [],                  # delivered-path futures to verify
            "all_futs": {},             # id -> fut (keeps ids stable)
            "completions": {},          # id -> completed-True count
            "failures": {},             # id -> {exc_name: count}
            "pub": {0: self.base.copy()},
            "cache_fills": [],          # (epoch, k, q, d, i)
            "cache_hits": [],           # (fut, epoch, k, q, d, i)
            "lock_violations": [],
        }

    def observer(self, ctx):
        cv, wl = ctx["cv"], ctx["wl"]

        def remember(fut) -> int:
            ctx["all_futs"][id(fut)] = fut
            return id(fut)

        def obs(name: str, obj: Any) -> None:
            if name == "journal.persist" and (cv.held() or wl.held()):
                where = "_cv" if cv.held() else "_wlock"
                ctx["lock_violations"].append(f"{name} while {where} held")
            elif name == "index.delta_cat" and cv.held():
                ctx["lock_violations"].append(f"{name} while _cv held")
            elif name == "engine.publish":
                ctx["pub"][obj.epoch] = np.concatenate(
                    [np.asarray(obj.core.series)]
                    + ([np.asarray(obj.delta_rows)]
                       if obj.delta_rows is not None else []),
                    axis=0).copy()
            elif name == "engine.future.fill":
                fut, src, n, completed = obj
                fid = remember(fut)
                if completed:
                    c = ctx["completions"]
                    c[fid] = c.get(fid, 0) + 1
            elif name == "engine.future.fail":
                fut, exc_name, failed = obj
                fid = remember(fut)
                if failed:
                    f = ctx["failures"].setdefault(fid, {})
                    f[exc_name] = f.get(exc_name, 0) + 1
            elif name == "engine.cache.fill":
                key, epoch, k, q, d, i = obj
                ctx["cache_fills"].append(
                    (epoch, k, q.copy(), d.copy(), i.copy()))
            elif name == "engine.cache.hit":
                fut, epoch, k, q, d, i = obj
                remember(fut)
                ctx["cache_hits"].append(
                    (fut, epoch, k, q.copy(), d.copy(), i.copy()))
        return obs

    # ----------------------------------------------------------- threads
    def _hot(self, ctx) -> None:
        from repro_torch.serve.engine import AdmissionError
        eng = ctx["eng"]
        for _ in range(2):              # second submit may hit the cache
            try:
                ctx["hot"].append(eng.submit(self.qh, k=2))
            except AdmissionError:
                pass
            eng.flush()

    def _batch_client(self, ctx) -> None:
        from repro_torch.serve.engine import AdmissionError
        eng = ctx["eng"]
        try:
            eng.submit(self.qb, k=1, priority="batch")
        except AdmissionError:
            pass
        eng.flush()

    def _deadline_client(self, ctx) -> None:
        from repro_torch.serve.engine import AdmissionError
        eng = ctx["eng"]
        try:                            # expires before any form() runs
            eng.submit(self.qd, k=1, deadline_ms=1e-3)
        except AdmissionError:
            pass
        try:                            # never expires
            eng.submit(self.qd, k=1, deadline_ms=60_000.0)
        except AdmissionError:
            pass
        eng.flush()

    def threads(self, ctx):
        return [("hot", lambda: self._hot(ctx)),
                ("batch", lambda: self._batch_client(ctx)),
                ("ddl", lambda: self._deadline_client(ctx)),
                ("add", lambda: ctx["eng"].add(self.extra)),
                ("flush", lambda: ctx["eng"].flush())]

    def finish(self, ctx, result):
        ctx["eng"].flush()              # uncontrolled drain

    # ------------------------------------------------------------ checks
    def check(self, ctx, result):
        eng = ctx["eng"]
        v = list(ctx["lock_violations"])
        # terminate-exactly-once: delivered XOR failed, exactly one
        for fid, fut in ctx["all_futs"].items():
            comp = ctx["completions"].get(fid, 0)
            nfail = sum(ctx["failures"].get(fid, {}).values())
            if comp and nfail:
                v.append(f"future both delivered ({comp}) and "
                         f"shed/expired ({nfail})")
            elif comp + nfail > 1:
                v.append(f"future terminated {comp + nfail} times")
            elif comp + nfail == 0 and fut.done():
                v.append("future done() with no terminal event observed")
            elif not fut.done():
                v.append(f"stranded caller: future never terminated "
                         f"(stalled={result.stalled})")
        # cache-epoch coherence: rows == oracle over the KEY's epoch
        for epoch, k, q, d, i in ctx["cache_fills"]:
            data = ctx["pub"].get(epoch)
            if data is None:
                v.append(f"cache fill keyed to unpublished epoch {epoch}")
                continue
            d_exp, i_exp = stub_topk(q[None], data, k)
            if not (np.array_equal(d, d_exp[0])
                    and np.array_equal(i, i_exp[0])):
                v.append(f"cache fill rows != epoch-{epoch} oracle")
        for fut, epoch, k, q, d, i in ctx["cache_hits"]:
            if epoch != fut.epoch:
                v.append(f"cache hit served epoch {epoch} to a future "
                         f"bound to epoch {fut.epoch}")
            data = ctx["pub"].get(epoch)
            if data is None:
                v.append(f"cache hit keyed to unpublished epoch {epoch}")
                continue
            d_exp, i_exp = stub_topk(q[None], data, k)
            if not (np.array_equal(d, d_exp[0])
                    and np.array_equal(i, i_exp[0])):
                v.append(f"cache hit rows != epoch-{epoch} oracle "
                         f"(cross-epoch contamination)")
        # counter conservation vs observed terminal failures by type
        adm = sum(f.get("AdmissionError", 0)
                  for f in ctx["failures"].values())
        ddl = sum(f.get("DeadlineExceeded", 0)
                  for f in ctx["failures"].values())
        if eng._shed + eng._evicted_batch != adm:
            v.append(f"shed counters {eng._shed}+{eng._evicted_batch} != "
                     f"{adm} observed AdmissionError terminations")
        if eng._deadline_expired != ddl:
            v.append(f"deadline_expired={eng._deadline_expired} != "
                     f"{ddl} observed DeadlineExceeded terminations")
        # delivered hot results: oracle + bit-identity across schedules
        for fut in ctx["hot"]:
            if ctx["failures"].get(id(fut)):
                continue
            data = ctx["pub"].get(fut.epoch)
            if data is None:
                v.append(f"hot future bound to unpublished epoch "
                         f"{fut.epoch}")
                continue
            d_exp, i_exp = stub_topk(self.qh, data, fut.k)
            if not (np.array_equal(fut._d, d_exp)
                    and np.array_equal(fut._i, i_exp)):
                v.append(f"hot result != oracle for epoch {fut.epoch}")
            key = (fut.epoch, fut.k)
            sig = (fut._d.tobytes(), fut._i.tobytes())
            prev = self._identity.setdefault(key, sig)
            if prev != sig:
                v.append(f"bit-identity broken across schedules for "
                         f"epoch {fut.epoch} (cache hit != cold run?)")
        return v


MAINT_PARK = ENGINE_PARK + ("engine.delete",)


def _snapshot_view(snap) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """(data, ids, alive) copies of everything a snapshot's plan reads —
    the recorded ground truth the tombstone-aware oracle runs over."""
    core = snap.core
    data = [np.asarray(core.series)]
    ids = [np.asarray(core.ids, np.int64)]
    alive = [np.ones(core.series.shape[0], bool) if core.alive is None
             else np.asarray(core.alive, bool)]
    if snap.delta_rows is not None:
        m = snap.delta_rows.shape[0]
        data.append(np.asarray(snap.delta_rows))
        ids.append(snap.n_base + np.arange(m, dtype=np.int64))
        da = getattr(snap, "delta_alive", None)
        alive.append(np.ones(m, bool) if da is None
                     else np.asarray(da, bool))
    a = np.concatenate(alive)
    return (np.concatenate(data, axis=0).copy(), np.concatenate(ids).copy(),
            None if a.all() else a.copy())


class MaintenanceScenario(Scenario):
    """Real QueryEngine over the lifecycle-aware StubIndex: a deleter
    (two core ids), an add-then-delete writer (one delta id), a
    searching client, a compactor, and a flusher, all racing under
    schedule exploration.

    Invariants (the lifecycle additions to the catalog):

    * NO RESURRECTED TOMBSTONE — a delivered result bound to epoch e
      never contains an id that is dead in e's view; every delivered
      result equals the tombstone-aware brute-force oracle over exactly
      that view (dead rows masked to +inf, never winning).
    * EXACTLY-ONCE PHYSICAL DROP — across every compaction in the run,
      each deleted id is physically removed exactly once (dropped_log),
      only requested ids are ever dropped, and after the final
      quiescent compaction no tombstone survives and no deleted row is
      physically present.
    * bit-identity ACROSS SCHEDULES keyed by the epoch's VIEW bytes
      (not the epoch number — racing writers make epoch numbering
      schedule-dependent): identical visible data + masks must yield
      byte-identical answers in every interleaving.
    * the same lock-discipline probes as EngineScenario.
    """

    def __init__(self, name: str = "maintenance"):
        self.name = name
        self.park_on = MAINT_PARK
        self._identity: Dict[Tuple, Tuple[bytes, bytes]] = {}
        rng = np.random.RandomState(13)
        self.base = rng.randn(6, 8).astype(np.float32)
        self.q0 = rng.randn(2, 8).astype(np.float32)
        self.extra = rng.randn(2, 8).astype(np.float32)
        self.core_dels = [1, 3]         # always-core ids
        self.delta_del = 6              # first id the add publishes

    def setup(self):
        from repro_torch.serve.engine import EngineConfig, QueryEngine
        ix = StubIndex(self.base)
        eng = QueryEngine(ix, EngineConfig(
            workers=0, linger_ms=0.0, help_after_ms=0.0, max_batch=4))
        eng.plans = StubPlans()
        cv = TrackedCondition(eng._cv)
        wl = TrackedLock(eng._wlock)
        eng._cv = cv
        eng._wlock = wl
        return {
            "eng": eng, "cv": cv, "wl": wl,
            "futs": [],
            "views": {0: _snapshot_view(eng._snapshots[0])},
            "deleted": [],              # ids whose delete() call returned
            "lock_violations": [],
        }

    def observer(self, ctx):
        cv, wl = ctx["cv"], ctx["wl"]

        def obs(name: str, obj: Any) -> None:
            if name == "journal.persist" and (cv.held() or wl.held()):
                where = "_cv" if cv.held() else "_wlock"
                ctx["lock_violations"].append(f"{name} while {where} held")
            elif name == "index.delta_cat" and cv.held():
                ctx["lock_violations"].append(f"{name} while _cv held")
            elif name == "engine.publish":
                ctx["views"][obj.epoch] = _snapshot_view(obj)
        return obs

    # ----------------------------------------------------------- threads
    def _client(self, ctx) -> None:
        eng = ctx["eng"]
        for _ in range(2):              # two submits bracket the races
            ctx["futs"].append(eng.submit(self.q0, k=2))
            eng.flush()

    def _deleter(self, ctx) -> None:
        ctx["eng"].delete(self.core_dels)
        ctx["deleted"].extend(self.core_dels)

    def _add_deleter(self, ctx) -> None:
        eng = ctx["eng"]
        eng.add(self.extra)
        eng.delete([self.delta_del])    # delta row (core if compacted)
        ctx["deleted"].append(self.delta_del)

    def threads(self, ctx):
        return [("c0", lambda: self._client(ctx)),
                ("del", lambda: self._deleter(ctx)),
                ("addel", lambda: self._add_deleter(ctx)),
                ("compact", lambda: ctx["eng"].compact()),
                ("flush", lambda: ctx["eng"].flush())]

    def finish(self, ctx, result):
        eng = ctx["eng"]
        eng.flush()                     # uncontrolled drain
        eng.compact()                   # quiescent: drop every tombstone

    # ------------------------------------------------------------ checks
    def check(self, ctx, result):
        eng = ctx["eng"]
        ix = eng._index
        v = list(ctx["lock_violations"])
        # exactly-once physical drop, across every compaction in the run
        dropped = [i for batch in ix.dropped_log for i in batch]
        if len(dropped) != len(set(dropped)):
            dupes = sorted(i for i in set(dropped) if dropped.count(i) > 1)
            v.append(f"tombstones physically dropped twice: {dupes}")
        requested = set(self.core_dels) | {self.delta_del}
        stray = set(dropped) - requested
        if stray:
            v.append(f"never-deleted ids physically dropped: "
                     f"{sorted(stray)}")
        # the finish() compaction is quiescent: nothing may survive it
        if ix._tombstones:
            v.append(f"tombstones survived the final compaction: "
                     f"{sorted(ix._tombstones)}")
        deleted = set(ctx["deleted"])
        resident = set(np.asarray(ix._core.ids).tolist()) & deleted
        if resident:
            v.append(f"deleted ids still physically present after final "
                     f"compaction: {sorted(resident)}")
        if set(dropped) != deleted:
            v.append(f"dropped ids {sorted(dropped)} != applied deletes "
                     f"{sorted(deleted)} (stalled={result.stalled})")
        # delivered results: tombstone-aware oracle + no resurrection +
        # bit-identity across schedules keyed by the VIEW bytes
        for ci, fut in enumerate(ctx["futs"]):
            if not fut.done():
                v.append(f"future {ci} incomplete after drain "
                         f"(stalled={result.stalled})")
                continue
            view = ctx["views"].get(fut.epoch)
            if view is None:
                v.append(f"future {ci} bound to unpublished epoch "
                         f"{fut.epoch}")
                continue
            data, ids, alive = view
            d_exp, i_exp = stub_topk_alive(self.q0, data, ids, alive,
                                           fut.k)
            if not (np.array_equal(fut._d, d_exp)
                    and np.array_equal(fut._i, i_exp)):
                v.append(f"future {ci} != tombstone-aware oracle for "
                         f"epoch {fut.epoch}")
            dead = set() if alive is None else \
                set(int(x) for x in ids[~alive])
            got = set(int(x) for x in fut._i.ravel() if x >= 0)
            zombies = got & dead
            if zombies:
                v.append(f"resurrected tombstone(s) {sorted(zombies)} in "
                         f"a result bound to epoch {fut.epoch}")
            key = (data.tobytes(), ids.tobytes(),
                   None if alive is None else alive.tobytes(), fut.k)
            sig = (fut._d.tobytes(), fut._i.tobytes())
            prev = self._identity.setdefault(key, sig)
            if prev != sig:
                v.append("bit-identity broken across schedules for an "
                         "identical tombstone view")
        return v


QUALITY_PARK = ENGINE_PARK


class QualityScenario(Scenario):
    """Real QueryEngine with `latency_tiers={"batch": target}` over a
    StubIndex carrying a stub calibration table: an exact client and an
    approx-tier client submit the SAME queries at the same (epoch, k) —
    twice each, so the second submit can hit the result cache — while a
    writer publishes a new epoch and a flusher races the helpers.

    The stub approx plan truncates the core candidate set (delta stays
    exact), so the two tiers provably return different bytes for the
    scenario's queries (the vacuity guard below machine-checks this).

    Invariants (the quality additions to the catalog):

    * TIER FIDELITY — every delivered exact-tier result equals the
      full brute-force oracle over its bound epoch's view, and every
      approx-tier result equals the TRUNCATED-core oracle over the same
      view.  A plan-cache or result-cache key collision between tiers
      (the bug `plan_key` exists to prevent) serves one tier's rows to
      the other and fails exactly one of these.
    * CACHE TIER/EPOCH COHERENCE — every result-cache hit serves rows
      equal to the hitting future's OWN tier oracle over the epoch in
      its key, and that epoch equals the future's bound epoch.
    * terminate-exactly-once per future (fills/completions counted).
    * bit-identity across schedules per (tier, epoch).
    * per-tier stats isolation: a tier that delivered work has its own
      counter bucket; the exact bucket never counts approx queries
      (checked via total-queries conservation).
    * the same lock-discipline probes as EngineScenario.
    """

    TARGET = 0.9
    STOP_LEAVES = 3

    def __init__(self, name: str = "quality"):
        self.name = name
        self.park_on = QUALITY_PARK
        self._identity: Dict[Tuple, Tuple[bytes, bytes]] = {}
        rng = np.random.RandomState(17)
        self.base = rng.randn(6, 8).astype(np.float32)
        # both queries' true nearest neighbors sit PAST the truncation
        # point, so exact and approx answers must differ at epoch 0
        self.q0 = (self.base[4:6] + 0.05 * rng.randn(2, 8)
                   ).astype(np.float32)
        self.extra = rng.randn(2, 8).astype(np.float32)

    def setup(self):
        from repro_torch.serve.engine import EngineConfig, QueryEngine
        ix = StubIndex(self.base)
        ix._calib = StubCalibration(k=2, target=self.TARGET,
                                    max_leaves=self.STOP_LEAVES,
                                    recall=self.TARGET)
        eng = QueryEngine(ix, EngineConfig(
            workers=0, linger_ms=0.0, help_after_ms=0.0, max_batch=4,
            cache_entries=8, latency_tiers={"batch": self.TARGET}))
        eng.plans = QualityStubPlans()
        cv = TrackedCondition(eng._cv)
        wl = TrackedLock(eng._wlock)
        eng._cv = cv
        eng._wlock = wl
        snap0 = eng._snapshots[0]
        return {
            "eng": eng, "cv": cv, "wl": wl,
            "exact": [], "approx": [],
            "tier_of": {},              # id(fut) -> "exact" | "approx"
            "views": {0: (np.asarray(snap0.core.series).copy(),
                          np.asarray(snap0.core.ids).copy(),
                          None, snap0.n_base)},
            "fills": {},                # (fut_id, src, n) -> count
            "completions": {},          # fut_id -> count
            "cache_hits": [],           # (fut, epoch, k, q, d, i)
            "lock_violations": [],
        }

    def observer(self, ctx):
        cv, wl = ctx["cv"], ctx["wl"]

        def obs(name: str, obj: Any) -> None:
            if name == "journal.persist" and (cv.held() or wl.held()):
                where = "_cv" if cv.held() else "_wlock"
                ctx["lock_violations"].append(f"{name} while {where} held")
            elif name == "index.delta_cat" and cv.held():
                ctx["lock_violations"].append(f"{name} while _cv held")
            elif name == "engine.publish":
                ctx["views"][obj.epoch] = (
                    np.asarray(obj.core.series).copy(),
                    np.asarray(obj.core.ids).copy(),
                    None if obj.delta_rows is None
                    else np.asarray(obj.delta_rows).copy(),
                    obj.n_base)
            elif name == "engine.future.fill":
                fut, src, n, completed = obj
                key = (id(fut), src, n)
                ctx["fills"][key] = ctx["fills"].get(key, 0) + 1
                if completed:
                    c = ctx["completions"]
                    c[id(fut)] = c.get(id(fut), 0) + 1
            elif name == "engine.cache.hit":
                fut, epoch, k, q, d, i = obj
                ctx["cache_hits"].append(
                    (fut, epoch, k, q.copy(), d.copy(), i.copy()))
        return obs

    # ----------------------------------------------------------- threads
    def _client(self, ctx, tier: str) -> None:
        eng = ctx["eng"]
        prio = "interactive" if tier == "exact" else "batch"
        for _ in range(2):              # second submit may hit the cache
            fut = eng.submit(self.q0, k=2, priority=prio)
            ctx["tier_of"][id(fut)] = tier
            ctx[tier].append(fut)
            eng.flush()

    def threads(self, ctx):
        return [("exact", lambda: self._client(ctx, "exact")),
                ("approx", lambda: self._client(ctx, "approx")),
                ("add", lambda: ctx["eng"].add(self.extra)),
                ("flush", lambda: ctx["eng"].flush())]

    def finish(self, ctx, result):
        ctx["eng"].flush()              # uncontrolled drain

    # ------------------------------------------------------------ checks
    def _oracle(self, view, q: np.ndarray, k: int, tier: str):
        """The tier's ground truth over one epoch view: full candidates
        for exact, first-STOP_LEAVES core rows + full delta for approx
        (byte-for-byte what _QualityStubPlan computes)."""
        core, cids, delta, n_base = view
        if tier == "approx":
            m = min(self.STOP_LEAVES, core.shape[0])
            core, cids = core[:m], cids[:m]
        data, ids = [core], [np.asarray(cids, np.int64)]
        if delta is not None:
            data.append(delta)
            ids.append(n_base + np.arange(delta.shape[0], dtype=np.int64))
        return stub_topk_alive(q, np.concatenate(data, axis=0),
                               np.concatenate(ids), None, k)

    def check(self, ctx, result):
        eng = ctx["eng"]
        v = list(ctx["lock_violations"])
        # vacuity guard: the two tiers MUST disagree on epoch 0, or the
        # aliasing detector below has no teeth
        d_e, i_e = self._oracle(ctx["views"][0], self.q0, 2, "exact")
        d_a, i_a = self._oracle(ctx["views"][0], self.q0, 2, "approx")
        if np.array_equal(i_e, i_a) and np.array_equal(d_e, d_a):
            v.append("scenario vacuous: exact and approx oracles agree "
                     "on epoch 0 — truncation lost its effect")
        delivered = {"exact": 0, "approx": 0}
        for tier in ("exact", "approx"):
            for ci, fut in enumerate(ctx[tier]):
                if not fut.done():
                    v.append(f"{tier} future {ci} incomplete after drain "
                             f"(stalled={result.stalled})")
                    continue
                delivered[tier] += fut._d.shape[0]
                view = ctx["views"].get(fut.epoch)
                if view is None:
                    v.append(f"{tier} future {ci} bound to unpublished "
                             f"epoch {fut.epoch}")
                    continue
                d_exp, i_exp = self._oracle(view, self.q0, fut.k, tier)
                if not (np.array_equal(fut._d, d_exp)
                        and np.array_equal(fut._i, i_exp)):
                    v.append(f"{tier} future {ci} != {tier} oracle for "
                             f"epoch {fut.epoch} — tier aliasing?")
                if ctx["completions"].get(id(fut), 0) != 1:
                    v.append(f"{tier} future {ci} completed "
                             f"{ctx['completions'].get(id(fut), 0)} times")
                key = (tier, fut.epoch)
                sig = (fut._d.tobytes(), fut._i.tobytes())
                prev = self._identity.setdefault(key, sig)
                if prev != sig:
                    v.append(f"bit-identity broken across schedules for "
                             f"({tier}, epoch {fut.epoch})")
        # exactly-once row delivery
        for (fid, src, n), count in ctx["fills"].items():
            if count != 1:
                v.append(f"rows [{src}:{src + n}] delivered {count} times")
        # cache hits serve the hitting future's own (tier, epoch)
        for fut, epoch, k, q, d, i in ctx["cache_hits"]:
            tier = ctx["tier_of"].get(id(fut))
            if tier is None:
                v.append("cache hit for a future no client submitted")
                continue
            if epoch != fut.epoch:
                v.append(f"cache hit served epoch {epoch} to a future "
                         f"bound to epoch {fut.epoch}")
            view = ctx["views"].get(epoch)
            if view is None:
                v.append(f"cache hit keyed to unpublished epoch {epoch}")
                continue
            d_exp, i_exp = self._oracle(view, q[None], k, tier)
            if not (np.array_equal(d, d_exp[0])
                    and np.array_equal(i, i_exp[0])):
                v.append(f"cache hit rows != {tier} oracle for epoch "
                         f"{epoch} (cross-tier cache aliasing)")
        # per-tier stats isolation: queries counted in the right bucket
        label = f"approx@{self.TARGET:g}"
        q_exact = eng._tier_stats.get("exact", {}).get("queries", 0)
        q_approx = eng._tier_stats.get(label, {}).get("queries", 0)
        if delivered["exact"] and q_exact != delivered["exact"]:
            v.append(f"exact tier counted {q_exact} queries, delivered "
                     f"{delivered['exact']}")
        if delivered["approx"] and q_approx != delivered["approx"]:
            v.append(f"{label} tier counted {q_approx} queries, "
                     f"delivered {delivered['approx']}")
        return v


PLAN_CACHE_PARK = ("plan_cache.get.lookup", "plan_cache.get.capture",
                   "plan_cache.get.store", "plan_cache.get.wait",
                   "plan_cache.drop")


class PlanCacheScenario(Scenario):
    """The REAL PlanCache over a real port index: `n_getters` threads get
    one key of the live epoch, one thread another key (another bucket),
    a late helper gets the first bucket's key of an older epoch, and a
    publish drops that older epoch (`drop_epochs`), all racing.  repro's
    engine scenarios stub the plan cache, so only this one can see a
    capture race.  On the CPU the plans are eager; over an index on the
    card each plan made is a CUDA graph capture, run while every other
    scheduled thread is parked.  The waiters park in a loop
    (`plan_cache.get.wait`), so explore it with RandomStrategy.

    Invariants (one capture):

    * at most one plan is made per key and epoch (`plan_cache.make`
      events, one per construction);
    * `hits + misses` equals the number of `get` calls;
    * no plan of the dropped epoch is kept, and no capture entry is left;
    * every caller receives a plan of its own (bucket, k, epoch), and
      callers of one key receive the same plan;
    * each plan's rows on the index's own rows equal the facade's
      search of those rows, byte for byte.
    """

    def __init__(self, name: str = "plan_cache", n_getters: int = 3,
                 index=None, buckets: Tuple[int, int] = (1, 8), k: int = 4,
                 cache_cls=None):
        if not 2 <= n_getters <= 4:
            raise ValueError("n_getters must be 2, 3 or 4")
        self.name = name
        self.park_on = PLAN_CACHE_PARK
        self.n_getters = n_getters
        self.buckets = buckets
        self.k = k
        self.cache_cls = cache_cls
        self._index = index
        self._fixture = None            # (snap_old, snap_live, knobs, rows)

    def _prepare(self):
        """The index (a small CPU one unless given), its two epochs'
        snapshots, the engine's knobs and the facade's answers."""
        if self._fixture is not None:
            return self._fixture
        import torch
        from repro_torch.serve.engine import EngineConfig, QueryEngine
        ix = self._index
        if ix is None:
            from repro_torch.api import FreshIndex, IndexConfig
            rng = np.random.RandomState(23)
            walks = np.cumsum(rng.randn(96, 32), axis=1).astype(np.float32)
            ix = FreshIndex.build(walks, IndexConfig(leaf_capacity=8),
                                  device="cpu")
            self._index = ix
        eng = QueryEngine(ix, EngineConfig(workers=0))
        old, live = eng._capture(0), eng._capture(1)
        knobs = eng._knobs
        eng.close()
        series = ix.index.series
        rows = {}
        for b in self.buckets:
            q = series[torch.arange(b, device=series.device)
                       % series.shape[0]].float()
            d, i = ix.search(q, k=self.k)
            rows[b] = (q.cpu().numpy(), d.cpu().numpy().reshape(b, -1),
                       i.cpu().numpy().reshape(b, -1))
        self._fixture = (old, live, knobs, rows)
        return self._fixture

    def setup(self):
        from repro_torch.serve.plan_cache import PlanCache
        old, live, knobs, rows = self._prepare()
        cls = self.cache_cls or PlanCache
        cache = cls(live.core.series.device)
        return {"cache": cache, "old": old, "live": live, "knobs": knobs,
                "rows": rows, "made": {}, "got": []}

    def observer(self, ctx):
        def obs(name: str, obj: Any) -> None:
            if name == "plan_cache.make":
                ctx["made"][obj] = ctx["made"].get(obj, 0) + 1
        return obs

    def _get(self, ctx, snap, bucket: int) -> None:
        plan = ctx["cache"].get(snap, bucket, self.k, ctx["knobs"])
        ctx["got"].append((snap.epoch, bucket, plan))

    def _publish(self, ctx) -> None:
        from .hooks import sync_point
        sync_point("plan_cache.drop")
        ctx["cache"].drop_epochs([ctx["old"].epoch])

    def threads(self, ctx):
        live, old = ctx["live"], ctx["old"]
        first, other = self.buckets
        ts = [(f"g{t}", lambda: self._get(ctx, live, first))
              for t in range(self.n_getters)]
        ts.append(("other", lambda: self._get(ctx, live, other)))
        ts.append(("late", lambda: self._get(ctx, old, first)))
        ts.append(("pub", lambda: self._publish(ctx)))
        return ts

    def check(self, ctx, result):
        cache, old = ctx["cache"], ctx["old"]
        v = []
        for key, n in ctx["made"].items():
            if n > 1:
                v.append(f"{n} plans made for key (bucket {key[0]}, epoch "
                         f"{key[1]}): a capture raced another")
        st = cache.stats()
        calls = len(ctx["got"])
        if st["hits"] + st["misses"] != calls:
            v.append(f"hits {st['hits']} + misses {st['misses']} != "
                     f"{calls} calls")
        if any(key[1] == old.epoch for key in cache._plans):
            v.append(f"a plan of dropped epoch {old.epoch} was kept")
        if cache._making:
            v.append(f"capture entries left behind: {list(cache._making)}")
        by_key: Dict[Tuple, Any] = {}
        checked = set()
        for epoch, bucket, plan in ctx["got"]:
            if (plan.bucket_q, plan.k, plan.snapshot.epoch) != \
                    (bucket, self.k, epoch):
                v.append(f"a caller of (bucket {bucket}, epoch {epoch}) "
                         f"received the plan of (bucket {plan.bucket_q}, "
                         f"epoch {plan.snapshot.epoch})")
            if by_key.setdefault((epoch, bucket), plan) is not plan:
                v.append(f"callers of (bucket {bucket}, epoch {epoch}) "
                         f"received different plans")
            if id(plan) in checked:
                continue
            checked.add(id(plan))
            q, d_exp, i_exp = ctx["rows"][bucket]
            d, i, _ = plan.run(q)
            if (d.tobytes(), i.tobytes()) != (d_exp.tobytes(),
                                              i_exp.tobytes()):
                v.append(f"plan (bucket {bucket}, epoch {epoch}) rows != "
                         f"the facade's search")
        return v


# shortcut constructors (importable names for tests / portfolio)
def refresh_scenario(**kw) -> RefreshScenario:
    return RefreshScenario(**kw)


def journal_scenario(**kw) -> JournalScenario:
    return JournalScenario(**kw)


def engine_scenario(**kw) -> EngineScenario:
    return EngineScenario(**kw)


def overload_scenario(**kw) -> OverloadScenario:
    return OverloadScenario(**kw)


def maintenance_scenario(**kw) -> MaintenanceScenario:
    return MaintenanceScenario(**kw)


def quality_scenario(**kw) -> QualityScenario:
    return QualityScenario(**kw)


def plan_cache_scenario(**kw) -> PlanCacheScenario:
    return PlanCacheScenario(**kw)


# ----------------------------------------------------------- exploration
@dataclass
class ExploreReport:
    """Outcome of exploring one scenario under one strategy."""
    scenario: str
    runs: int = 0
    distinct: int = 0
    steps: int = 0
    diverged: int = 0
    stalled_runs: int = 0
    violations: List[str] = field(default_factory=list)
    seconds: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.violations

    def line(self) -> str:
        status = "OK" if self.ok else f"{len(self.violations)} VIOLATIONS"
        return (f"{self.scenario:<18} runs={self.runs:<6} "
                f"distinct={self.distinct:<6} steps={self.steps:<7} "
                f"stalls={self.stalled_runs:<5} {self.seconds:6.1f}s "
                f"{status}")


def explore(scenario: Scenario, strategy: Strategy, budget: int,
            max_steps: int = 20_000, stop_after: int = 10,
            ) -> ExploreReport:
    """Run up to `budget` schedules of `scenario` under `strategy`,
    checking invariants after each; stops early when the strategy
    exhausts its schedule space or `stop_after` violations accumulate."""
    rep = ExploreReport(scenario=scenario.name)
    sched = ControlledScheduler(strategy, park_on=scenario.park_on,
                                max_steps=max_steps)
    seen: set = set()
    t0 = time.perf_counter()
    for _ in range(budget):
        if strategy.exhausted:
            break
        ctx = scenario.setup()
        obs = scenario.observer(ctx)
        try:
            result = sched.run(scenario.threads(ctx), observer=obs)
        except (SchedulerHang, ScheduleLivelock) as e:
            rep.runs += 1
            rep.violations.append(f"liveness: {type(e).__name__}: {e}")
            break
        if obs is not None:
            with installed(_ObserveForwarder(obs)):
                scenario.finish(ctx, result)
        else:
            scenario.finish(ctx, result)
        rep.runs += 1
        rep.steps += result.steps
        rep.diverged += bool(result.diverged)
        rep.stalled_runs += bool(result.stalled)
        seen.add(result.signature())
        for name, err in result.errors.items():
            rep.violations.append(
                f"thread {name} raised {type(err).__name__}: {err} "
                f"[schedule {result.trace[-6:]}]")
        rep.violations.extend(scenario.check(ctx, result))
        if len(rep.violations) >= stop_after:
            break
    rep.distinct = len(seen)
    rep.seconds = time.perf_counter() - t0
    return rep


# ------------------------------------------------------------- portfolio
def make_portfolio(budget: int, seed: int = 0,
                   journal_dir: Optional[str] = None
                   ) -> List[Tuple[str, Scenario, Strategy, int]]:
    """The standard scenario/strategy mix, budget split across prongs.

    Weights favour the stub-free refresh/journal scenarios (cheapest per
    schedule) while keeping every invariant family covered."""
    b = max(budget, 10)
    mix = [
        ("refresh.dfs",
         RefreshScenario(n_threads=2),
         DFSStrategy(max_preemptions=2), int(b * 0.26)),
        ("refresh.stall",
         RefreshScenario(n_threads=3),
         RandomStrategy(seed=seed + 1, p_stall=0.25,
                        stall_points=REFRESH_STALL), int(b * 0.16)),
        ("journal.dfs",
         JournalScenario(),
         DFSStrategy(max_preemptions=2), int(b * 0.22)),
        ("journal.random",
         JournalScenario(n_workers=3),
         RandomStrategy(seed=seed + 2), int(b * 0.10)),
        ("engine.race",
         EngineScenario(name="engine.race", auto_compact=2),
         RandomStrategy(seed=seed + 3), int(b * 0.11)),
        ("engine.lockfree",
         EngineScenario(name="engine.lockfree", lockfree=True),
         RandomStrategy(seed=seed + 4, p_stall=0.35,
                        stall_points=ENGINE_STALL), int(b * 0.08)),
        ("engine.durable",
         EngineScenario(name="engine.durable", journal_dir=journal_dir),
         RandomStrategy(seed=seed + 5), int(b * 0.03)),
        ("engine.overload",
         OverloadScenario(name="engine.overload"),
         RandomStrategy(seed=seed + 6, p_stall=0.15,
                        stall_points=ENGINE_STALL), int(b * 0.06)),
        ("engine.maint",
         MaintenanceScenario(name="engine.maint"),
         RandomStrategy(seed=seed + 7), int(b * 0.08)),
        ("engine.quality",
         QualityScenario(name="engine.quality"),
         RandomStrategy(seed=seed + 8), int(b * 0.08)),
        ("plan_cache.race",
         PlanCacheScenario(name="plan_cache.race"),
         RandomStrategy(seed=seed + 9), int(b * 0.05)),
    ]
    return mix


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.checker",
        description="Schedule-exploring race checker for the port's "
                    "lock-free core and serving engine.")
    # The DFS scenarios exhaust their bounded-preemption space below
    # their slice; 15k leaves the random scenarios enough headroom that
    # the full portfolio clears >10k DISTINCT interleavings.
    ap.add_argument("--budget", type=int, default=15_000,
                    help="total schedules across the portfolio "
                         "(default 15000; CI uses a few hundred)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scenario", type=str, default=None,
                    help="run only portfolio entries whose name contains "
                         "this substring")
    args = ap.parse_args(argv)

    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        mix = make_portfolio(args.budget, seed=args.seed, journal_dir=tmp)
        if args.scenario:
            mix = [m for m in mix if args.scenario in m[0]]
            if not mix:
                print(f"no portfolio entry matches {args.scenario!r}")
                return 2
        reports: List[ExploreReport] = []
        for label, scenario, strategy, share in mix:
            scenario.name = label
            rep = explore(scenario, strategy, budget=share)
            reports.append(rep)
            print(rep.line(), flush=True)

    total_runs = sum(r.runs for r in reports)
    total_distinct = sum(r.distinct for r in reports)
    bad = [r for r in reports if not r.ok]
    print(f"\ntotal: {total_runs} schedules, {total_distinct} distinct "
          f"interleavings, {len(bad)} scenario(s) with violations")
    for r in bad:
        for msg in r.violations[:10]:
            print(f"  [{r.scenario}] {msg}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
