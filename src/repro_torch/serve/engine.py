"""QueryEngine: the serving-layer API over a FreshIndex of the port.

    engine = index.engine(EngineConfig(max_batch=32, workers=1))
    fut = engine.submit(q, k=10)          # single query or small batch
    dist, ids = fut.result()              # shaped like FreshIndex.search

The port's counterpart of `repro.serve.engine`, for a local or a sharded
index.  The paper's whole point is an index that keeps answering
queries while writers make progress; Jiffy (arXiv:2102.01044) shows the
API shape — batch updates plus snapshot reads that never block each
other.  This module is that shape for the index on the card:

* submit() enqueues and returns a SearchFuture; the micro-batcher
  (`serve.batcher`) pads pending queries into a fixed set of shape
  buckets and dispatches them through captured plans
  (`serve.plan_cache`: one CUDA graph per (bucket, k, knobs, epoch) on
  the card), so steady-state serving replays and never captures.
* add() publishes a new immutable epoch SNAPSHOT (compacted core + the
  delta rows as compaction will store them, Jiffy-style).  Every query
  is bound to the epoch current at submit time: an in-flight batch
  finishes on the snapshot it started with — a post-publish submit sees
  the new series.  Writers never block readers, readers never block
  writers.
* dispatched batches are registered in a `repro_torch.runtime.WorkJournal`
  part; if the worker executing a batch dies mid-flight, any other
  worker — or a caller blocked in result(), or flush() — HELPS by
  re-executing the orphaned part (search is pure, so at-least-once
  execution is safe; futures fill idempotently).  This is the paper's
  expeditive/standard helping transplanted to the serving plane.
* stats() exposes queue depth, p50/p99 latency, rounds-per-query, epoch
  lag, plan-cache hit rates, padding overhead and the mesh.
* a SHARDED index (`index.shard(mesh)`) serves too: its snapshots are
  mesh-wide (the masked shards, one per slot, and the delta rows), its
  plans are `ShardedCompiledPlan`s (the facade's sharded search, run
  eagerly, `sync_every` from EngineConfig), compaction re-pads and
  re-shards, and `recover(checkpoint, mesh=...)` restores the arrays and
  re-shards them over the surviving devices.

Threading: `workers=0` (default) is synchronous — batches dispatch on
flush() or inside result(); `workers=N` starts N daemon threads that
linger `linger_ms` to let buckets fill, then dispatch.  Nothing that
waits on the card (a copy to the host, a synchronize, a capture) runs
under the engine's condition variable.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.hooks import observe, sync_point
from repro_torch.core.refresh import WorkerCrash
from repro_torch.maintenance import MaintenancePolicy, MaintenanceState
from repro_torch.runtime import WorkJournal
from repro_torch.runtime.elastic import plan_serving_mesh
from repro_torch.runtime.sharding import Mesh, mesh_sig

from .batcher import (Batch, MicroBatcher, Pending, earliest_deadline,
                      shape_buckets)
from .plan_cache import Knobs, PlanCache, plan_key
from .result_cache import ResultCache, query_fingerprint

_PRIORITIES = ("interactive", "batch")
_OVERFLOW_POLICIES = ("shed", "deadline")

# Journal owner id used by helping callers (flush / a blocked result()).
# Must be >= 0: WorkJournal treats owner < 0 as "unowned", so a negative
# helper id would leave helped parts re-acquirable by live workers.
HELPER_ID = 1 << 30


class AdmissionError(RuntimeError):
    """A submit was shed by admission control: the pending-queue budget
    (`EngineConfig.max_pending` / `max_pending_per_class`) was exhausted
    and the overflow policy is "shed" — or a queued batch-priority
    submit was evicted to make room for an interactive one.  The query
    was never enqueued (or was removed before forming); resubmit later
    or at lower offered load."""


class DeadlineExceeded(RuntimeError):
    """A submitted query expired in the pending queue: its
    `deadline_ms` passed before the micro-batcher formed it into a
    dispatch.  The future is terminally failed — `result()` raises this
    instead of stranding the caller — and the query never executed."""


class ResultTimeout(TimeoutError):
    """`SearchFuture.result(timeout=...)` gave up waiting.  Unlike
    AdmissionError/DeadlineExceeded this is NOT a terminal state: the
    future stays registered and completable, and a later worker, helper
    or `result()` call can still deliver the rows."""


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Every serving knob in one frozen place (mirrors IndexConfig).

    max_batch       largest dispatch bucket; buckets are the powers of two
                    up to it (shape_buckets)
    linger_ms       async workers wait this long for a bucket to fill
    workers         background dispatch threads (0 = synchronous mode)
    donate          the plans own their device buffers: each is one
                    captured CUDA graph (None = auto: on for a CUDA
                    index, off for a CPU one, where True raises — see
                    PlanCache)
    warm_ks         k values warmup() captures plans for
    help_after_ms   how long result() waits on async workers before it
                    starts helping (journal steal of orphaned batches)
    latency_window  completed-query latencies kept for p50/p99
    journal_path    optional on-disk WorkJournal (crash-durable helping);
                    None keeps the journal in memory.  A restarted
                    engine retires unfinished parts it reloads: their
                    batches and futures died with the crashed process,
                    so clients must resubmit — the journal preserves
                    ids/stats across restarts, not query payloads
    auto_compact_rows
                    when set, add() compacts the index as soon as the
                    pending delta reaches this many rows — an incremental
                    sorted-run merge (core.builder.merge_sorted_delta)
                    that consumes the stored core arrays as-is, published
                    as a delta-free epoch so steady-state plans return to
                    the core-only program.  None = only explicit compact().
                    DEPRECATED in favour of `maintenance` (mutually
                    exclusive): `MaintenancePolicy.compact_every(rows)`
                    keeps this trigger and adds TTL sweeps + tombstone
                    staleness budgets
    maintenance     a `repro_torch.maintenance.MaintenancePolicy`: freshness-
                    tiered scheduling of TTL expiry sweeps, auto-
                    compaction (row count, dead fraction, OR tombstone
                    staleness budget) and policy-driven checkpointing.
                    Each due task runs as a journal-registered part, so
                    a maintainer that dies mid-task is helped by any
                    surviving worker / flush() / blocked result() —
                    never wedged — exactly like a dispatched batch.
                    None = no background maintenance (explicit
                    delete()/expire_ttl()/compact() still work)
    sync_every      SHARDED serving only: refinement rounds between two
                    publications of the global k-th bound (the min over
                    shards); local plans ignore it
    max_pending     admission budget: total queued query ROWS (across
                    both priority classes) a submit may not push past.
                    Over budget, batch-priority pendings are evicted
                    first to admit interactive work; what still does not
                    fit is handled per overflow_policy.  None (default)
                    = unbounded queue (the pre-admission behavior)
    max_pending_per_class
                    optional {"interactive": n, "batch": n} per-class
                    row budgets checked before the shared max_pending;
                    classes absent from the mapping are uncapped
    overflow_policy "shed": an over-budget submit raises AdmissionError
                    immediately (never enqueued).  "deadline": it is
                    admitted anyway but stamped with a deadline of at
                    most overflow_deadline_ms, so it either dispatches
                    promptly or expires with DeadlineExceeded — the
                    queue stays bounded in time instead of in space
    overflow_deadline_ms
                    the deadline stamped on over-budget submits under
                    overflow_policy="deadline" (tightened to the
                    submit's own deadline_ms when that is sooner)
    cache_entries   capacity (in rows) of the epoch-keyed result cache
                    consulted before batching; 0 (default) disables it.
                    Entries are keyed by (query-hash, epoch) +
                    plan_key(k, knobs) — every search-semantics knob,
                    including the quality tier's stop rule — so every
                    add()/compact()/recover() invalidates for free by
                    advancing the epoch and exact/approx results never
                    alias
    latency_tiers   optional {priority_class: tier} quality mapping:
                    "exact" (certified k-NN, the default for classes
                    absent from the mapping) or a float recall target in
                    (0, 1] — that class's submits then serve through the
                    approx plan whose stop rule the index's
                    CalibrationTable fitted for (k, target) (run
                    index.calibrate() first; an uncalibrated target
                    raises at submit time).  Per-tier counters appear in
                    stats()["quality"]
    round_leaves / pq_budget / max_rounds
                    per-engine search-knob overrides; None defers to the
                    index's `search_knobs()` (max_rounds: exact search)
    """
    max_batch: int = 64
    linger_ms: float = 2.0
    workers: int = 0
    donate: Optional[bool] = None
    warm_ks: Tuple[int, ...] = (1, 10)
    help_after_ms: float = 50.0
    latency_window: int = 4096
    journal_path: Optional[str] = None
    auto_compact_rows: Optional[int] = None
    maintenance: Optional[MaintenancePolicy] = None
    sync_every: int = 1
    max_pending: Optional[int] = None
    max_pending_per_class: Optional[dict] = None
    overflow_policy: str = "shed"
    overflow_deadline_ms: float = 50.0
    cache_entries: int = 0
    latency_tiers: Optional[dict] = None
    round_leaves: Optional[int] = None
    pq_budget: Optional[int] = None
    max_rounds: Optional[int] = None

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.max_pending is not None and self.max_pending < 1:
            raise ValueError("max_pending must be >= 1 or None")
        if self.max_pending_per_class is not None:
            for cls, cap in self.max_pending_per_class.items():
                if cls not in _PRIORITIES:
                    raise ValueError(
                        f"max_pending_per_class keys must be in "
                        f"{_PRIORITIES}, got {cls!r}")
                if cap < 1:
                    raise ValueError(
                        f"max_pending_per_class[{cls!r}] must be >= 1")
        if self.overflow_policy not in _OVERFLOW_POLICIES:
            raise ValueError(f"overflow_policy must be one of "
                             f"{_OVERFLOW_POLICIES}, got "
                             f"{self.overflow_policy!r}")
        if self.overflow_deadline_ms <= 0:
            raise ValueError("overflow_deadline_ms must be > 0")
        if self.cache_entries < 0:
            raise ValueError("cache_entries must be >= 0")
        if self.latency_tiers is not None:
            for cls, tier in self.latency_tiers.items():
                if cls not in _PRIORITIES:
                    raise ValueError(
                        f"latency_tiers keys must be in {_PRIORITIES}, "
                        f"got {cls!r}")
                if tier != "exact" and not (
                        isinstance(tier, (int, float))
                        and 0.0 < float(tier) <= 1.0):
                    raise ValueError(
                        f"latency_tiers[{cls!r}] must be 'exact' or a "
                        f"recall target in (0, 1], got {tier!r}")
        if self.auto_compact_rows is not None and self.auto_compact_rows < 1:
            raise ValueError("auto_compact_rows must be >= 1 or None")
        if self.maintenance is not None:
            if not isinstance(self.maintenance, MaintenancePolicy):
                raise ValueError(
                    f"maintenance must be a MaintenancePolicy or None, "
                    f"got {type(self.maintenance).__name__}")
            if self.auto_compact_rows is not None:
                raise ValueError(
                    "auto_compact_rows and maintenance are mutually "
                    "exclusive; migrate to maintenance="
                    "MaintenancePolicy.compact_every(rows)")
        if self.sync_every < 1:
            raise ValueError("sync_every must be >= 1")
        if self.workers < 0:
            raise ValueError("workers must be >= 0")
        if self.linger_ms < 0 or self.help_after_ms < 0:
            raise ValueError("linger_ms / help_after_ms must be >= 0")
        if self.latency_window < 1:
            raise ValueError("latency_window must be >= 1")


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """One immutable published epoch: the masked core + the delta rows.

    The FlatIndex tensors and the delta rows are device tensors that are
    never mutated in place — add() publishes a NEW snapshot and compact()
    swaps in a NEW core, so a batch holding this object answers exactly
    on the data visible at its submit epoch, forever.  The epoch's plans
    read these tensors (a CUDA graph keeps their addresses), so they
    live while the epoch does."""
    epoch: int
    core: object                       # FlatIndex (tombstone-masked view)
    # the pending delta as compaction will store it (FreshIndex.
    # delta_rows), the rows the facade's delta scan reads; None if empty
    delta_rows: Optional[torch.Tensor]
    n_base: int                        # delta id offset (see search_view)
    n_total: int                       # searchable series (tombstones out)
    series_len: int
    delta_alive: Optional[torch.Tensor] = None  # (m,) bool tombstone mask
    # internal-id -> stable-id renames (FreshIndex.update), frozen at
    # capture: a batch answering on this snapshot remaps with the alias
    # view its submit epoch saw, never a later writer's
    id_alias: tuple = ()
    # a sharded index: the mesh, its axis, and the masked core's leaf
    # blocks (FreshIndex.shard_view), one per slot: the epoch is
    # MESH-WIDE, one pointer swap publishes every shard's view at once
    mesh: object = None
    mesh_axis: str = "data"
    shards: Optional[tuple] = None

    @property
    def placement(self) -> Optional[tuple]:
        """None for a local snapshot, else (axis,) + `mesh_sig(mesh)`:
        part of every plan key, so a plan made for one placement never
        serves another (an elastic re-mesh makes fresh plans)."""
        if self.mesh is None:
            return None
        return (self.mesh_axis,) + mesh_sig(self.mesh)


class SearchFuture:
    """Handle for one submit(): fills as its batch(es) complete.

    Filling is idempotent per row (a journal helper may re-execute a
    batch a crashed worker had already partially delivered), and one
    future may span several dispatch buckets when a submit is larger than
    max_batch."""

    def __init__(self, engine: "QueryEngine", n_rows: int, k: int,
                 epoch: int, submitted_at: float):
        self._engine = engine
        self.k = k
        self.epoch = epoch
        self.submitted_at = submitted_at
        self.completed_at: Optional[float] = None
        self._d = np.empty((n_rows, k), np.float32)
        self._i = np.empty((n_rows, k), np.int32)
        self._filled = np.zeros((n_rows,), bool)
        self._error: Optional[Exception] = None
        self._lock = threading.Lock()
        self._event = threading.Event()

    def _fill(self, src: int, d_rows: np.ndarray, i_rows: np.ndarray,
              now: float) -> bool:
        """Deliver rows [src, src+n).  True exactly once: on completion.
        A future already terminally failed (_fail) absorbs nothing — a
        shed or expired query can never ALSO be delivered."""
        completed = False
        with self._lock:
            n = d_rows.shape[0]
            if self._error is not None:
                observe("engine.future.fill", (self, src, n, False))
                return False
            self._d[src:src + n] = d_rows
            self._i[src:src + n] = i_rows
            self._filled[src:src + n] = True
            if self._filled.all() and not self._event.is_set():
                self.completed_at = now
                self._event.set()
                completed = True
        observe("engine.future.fill", (self, src, n, completed))
        return completed

    def _fail(self, exc: Exception, now: float) -> bool:
        """Terminally fail the future (shed / deadline-expired): result()
        raises `exc` instead of returning rows.  True exactly once — a
        future that already completed (or already failed) is untouched,
        so a delivered query can never ALSO be shed."""
        failed = False
        with self._lock:
            if not self._event.is_set():
                self._error = exc
                self.completed_at = now
                self._event.set()
                failed = True
        observe("engine.future.fail",
                (self, type(exc).__name__, failed))
        return failed

    def done(self) -> bool:
        """True once the future has terminated: every row delivered, or
        terminally failed (shed / deadline-expired)."""
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(dist, ids), shaped exactly like FreshIndex.search: (Q, k),
        with the k dimension squeezed when k == 1.  Blocks; in sync mode
        (workers=0) this drives the dispatch itself, in async mode it
        waits `help_after_ms` then starts helping via the journal.

        Raises ResultTimeout when `timeout` seconds elapse first — never
        partial rows — and the future stays completable: a later worker,
        helper, or result() call can still deliver it.  Raises the
        terminal AdmissionError / DeadlineExceeded if the engine shed or
        expired this query."""
        deadline = None if timeout is None else time.monotonic() + timeout

        def _timed_out() -> bool:
            return deadline is not None and time.monotonic() > deadline

        grace = self._engine.config.help_after_ms / 1e3
        if not self._event.is_set():
            if self._engine.has_live_workers():
                wait = grace
                if deadline is not None:
                    wait = max(0.0, min(grace,
                                        deadline - time.monotonic()))
                self._event.wait(wait)
            while not self._event.is_set():
                if _timed_out():
                    raise ResultTimeout(
                        f"search result not ready within {timeout}s "
                        f"({int(self._filled.sum())}/{len(self._filled)} "
                        f"rows filled); the future remains completable")
                self._engine._make_progress()
                if self._event.wait(0.005):
                    break
                if _timed_out():
                    raise ResultTimeout(
                        f"search result not ready within {timeout}s "
                        f"({int(self._filled.sum())}/{len(self._filled)} "
                        f"rows filled); the future remains completable")
        if self._error is not None:
            raise self._error
        if self.k == 1:
            return self._d[:, 0], self._i[:, 0]
        return self._d, self._i


class QueryEngine:
    """See module docstring.  Construct via `FreshIndex.engine()`."""

    def __init__(self, index, config: Optional[EngineConfig] = None):
        cfg = config or EngineConfig()
        self._index = index
        self.config = cfg
        icfg = index.config
        # resolve the index-side knobs ONCE, through the same chain
        # search() uses (IndexConfig > fresh autotune table > static
        # defaults); the resolved values land in Knobs and therefore in
        # plan_key, so a retuned table can never alias a stale plan or
        # result-cache entry
        kn = index.search_knobs()
        self._knobs = Knobs(
            round_leaves=(cfg.round_leaves if cfg.round_leaves is not None
                          else kn.round_leaves),
            znorm=icfg.znorm,
            max_rounds=cfg.max_rounds,
            pq_budget=(cfg.pq_budget if cfg.pq_budget is not None
                       else kn.pq_budget),
            sync_every=cfg.sync_every)
        self.plans = PlanCache(index.device, donate=cfg.donate)
        self._batcher = MicroBatcher(cfg.max_batch)
        self._cv = threading.Condition(threading.RLock())
        # serializes index WRITERS (add/compact/refresh) so the heavy
        # compaction merge can run outside _cv without racing another
        # writer; readers keep going under _cv the whole time
        self._wlock = threading.Lock()
        # autopersist=False: journal mutations happen under _cv, so the
        # on-disk write is deferred — each mutating section captures a
        # consistent journal.snapshot() while it still holds _cv and
        # hands it to persist() after release (no file I/O under the
        # condition variable, and the file can never mix states from
        # before and after a concurrent mutation — enforced by
        # repro.analysis.lint)
        self._journal = WorkJournal(cfg.journal_path, n_parts=0,
                                    autopersist=False)
        # A journal reloaded after a crash can hold unfinished parts.
        # Their batches — and the futures those batches fed — died with
        # the old process, so no execution can ever deliver or finish
        # them: retire them up front, or every helper (worker loops,
        # flush(), a blocked result()) would re-steal them forever.
        for pid in self._journal.unfinished():
            self._journal.discard(pid)
        self._journal.prune_done()
        self._journal.persist()
        self._batches: dict = {}            # part_id -> Batch (unfinished)
        self._pending: list = []            # [Pending]
        # epoch-keyed result cache; get/put only under _cv (O(1) work)
        self._cache = (ResultCache(cfg.cache_entries)
                       if cfg.cache_entries else None)
        self._epoch = 0
        self._snapshots = {0: self._capture(0)}
        self._closed = False
        # stats
        self._latencies: deque = deque(maxlen=cfg.latency_window)
        self._rounds_sum = 0.0
        self._rounds_n = 0
        self._completed = 0
        self._dispatched = 0
        self._padded_slots = 0
        self._compactions = 0
        self._recoveries = 0
        self._shed = 0                      # submits refused admission
        self._shed_rows = 0
        # ---- quality tiers (repro_torch.quality): per-tier counters.
        # Keys are tier labels ("exact" / "approx@0.95"); mutated only
        # under _cv.  `_tier_recall` records the advertised (calibrated)
        # recall per approx tier at resolution time.
        self._tiers = dict(cfg.latency_tiers or {})
        self._tier_stats: dict = {}
        self._tier_recall: dict = {}
        self._evicted_batch = 0             # queued batch submits evicted
        self._overflow_queued = 0           # admitted-with-deadline submits
        self._deadline_expired = 0          # futures expired in the queue
        self._first_submit: Optional[float] = None
        self._crashed_workers = 0
        self._crash_hook = None             # test injection: fn(wid, batch)
        # ---- policy-driven maintenance (repro_torch.maintenance) ----
        # Each due task becomes a journal part (part_id -> kind) executed
        # through the same acquire/steal/help machinery as batches, so a
        # maintainer that dies mid-task is helped, never wedged.
        self._policy = cfg.maintenance
        self._maint_parts: dict = {}        # part_id -> task kind
        self._maint_inflight: set = set()   # kinds scheduled, not done
        now = time.monotonic()
        self._last_sweep = now
        self._last_checkpoint = now
        self._maint_counts = {"sweep": 0, "compact": 0, "checkpoint": 0}
        self._workers = [
            threading.Thread(target=self._worker_loop, args=(i,),
                             name=f"fresh-serve-{i}", daemon=True)
            for i in range(cfg.workers)]
        for t in self._workers:
            t.start()

    # ------------------------------------------------------------------ #
    # snapshots (Jiffy-style epochs)
    # ------------------------------------------------------------------ #
    def _capture(self, epoch: int) -> Snapshot:
        # search_view is the tombstone-masked read surface: the core a
        # dead row can never win, the delta alive-mask, and the delta id
        # offset.  Deletes/TTL expiry thus ride the SAME epoch machinery
        # as adds — publish a snapshot, and every later submit (and every
        # result-cache key) sees the post-delete world.  The delta rows
        # (summarized on the device) are what the facade's scan reads.
        ix = self._index
        core, delta, alive, id0 = ix.search_view()
        return Snapshot(epoch=epoch, core=core,
                        delta_rows=None if delta is None else ix.delta_rows,
                        n_base=id0, n_total=ix.n_series,
                        series_len=ix.series_len,
                        delta_alive=alive,
                        id_alias=tuple(sorted(ix._alias.items())),
                        mesh=ix.mesh, mesh_axis=ix.mesh_axis,
                        shards=ix.shard_view())

    def _publish(self) -> None:
        """Capture OUTSIDE _cv (capturing concatenates and summarizes
        the pending delta on the device — work readers must not stall
        behind), then publish under _cv as a pure pointer swap, dropping
        the epochs no one can read any more.  Callers hold _wlock, so
        the capture cannot race another writer and the epoch read below
        is stable."""
        snap = self._capture(self._epoch + 1)
        observe("engine.publish", snap)
        with self._cv:
            self._epoch = snap.epoch
            self._snapshots[snap.epoch] = snap
            dead = self._gc_snapshots()
            self._cv.notify_all()
        self.plans.drop_epochs(dead)

    @property
    def epoch(self) -> int:
        """The currently published epoch number (0 at construction)."""
        return self._epoch

    def add(self, batch, *, ttl_s: Optional[float] = None) -> "QueryEngine":
        """Append `batch` ((L,) or (m, L) series) and publish a new
        epoch snapshot.  In-flight queries keep answering on their
        submit-time snapshot; queries submitted after this call see the
        new series.  When `auto_compact_rows` is set and the pending
        delta reaches it, the delta is folded into the core first
        (incremental sorted-run merge) and the published epoch is
        delta-free.  `ttl_s` gives the batch a time-to-live
        (FreshIndex.add): a `maintenance` policy's sweeps expire it
        automatically.  Returns self.

        Raises:
            ValueError: batch shape mismatch / bad ttl_s (FreshIndex.add).

        Concurrency: a writer — serializes with compact/refresh/recover
        on the writer lock; never blocks readers (the heavy merge runs
        OUTSIDE the engine condition variable, so concurrent
        submit()/result() never stall behind a compaction).
        """
        sync_point("engine.add")
        cap = self.config.auto_compact_rows
        with self._wlock:
            # the index mutation and the host->device delta transfer run
            # OUTSIDE _cv: writers are already serialized by _wlock and
            # readers only ever see published snapshots, so only the
            # publish pointer swap needs the condition variable
            self._index.add(batch, ttl_s=ttl_s)
            if cap is None or self._index.n_pending < cap:
                self._publish()
                return self
            self._compact_locked()
        return self

    def update(self, sid: int, series, *,
               ttl_s: Optional[float] = None) -> "QueryEngine":
        """Replace series `sid` in place under its stable id
        (FreshIndex.update) and publish the retire+introduce pair as ONE
        epoch — the atomicity the facade cannot give: a concurrent
        reader either answers on the pre-update snapshot (old values,
        one live row for `sid`) or the post-update snapshot (new values,
        one live row), never a world with zero or two live rows for the
        id.  Returns self.

        Args:
            sid: stable id of a currently-live series.
            series: the new (L,) values.
            ttl_s: optional time-to-live for the new values.
        Raises:
            ValueError: `sid` not live / wrong series shape
                (FreshIndex.update).

        Concurrency: a writer on the writer lock, like add(); the single
        _publish() after both mutations is what makes the pair atomic
        for readers.
        """
        sync_point("engine.update")
        with self._wlock:
            self._index.update(sid, series, ttl_s=ttl_s)
            before = self._epoch
            self._publish()
            assert self._epoch > before, \
                "update() must advance the snapshot epoch"
        return self

    def delete(self, ids) -> int:
        """Logically delete series by id (FreshIndex.delete) and publish
        a new epoch.  `ids` is one id or an iterable of stable series
        ids; already-deleted and already-dropped ids are skipped,
        never-assigned ids raise ValueError.
        Queries submitted after this call can never return
        the deleted series — including via the result cache, whose keys
        carry the epoch, so the publish IS the invalidation.  In-flight
        batches complete on their submit-time snapshot (the same
        relaxed-consistency contract adds have).  Physical removal
        happens at the next compaction (a `maintenance` policy schedules
        one within its staleness budget).  Returns the number of newly
        deleted series.

        Concurrency: a writer on the writer lock, like add().
        """
        sync_point("engine.delete")
        with self._wlock:
            n = self._index.delete(ids)
            if n:
                before = self._epoch
                self._publish()
                # the epoch-keyed result cache can never serve a deleted
                # series only BECAUSE the epoch advanced — keep that
                # invariant loud
                assert self._epoch > before, \
                    "delete() must advance the snapshot epoch"
        return n

    def expire_ttl(self, now: Optional[float] = None) -> int:
        """Run one TTL expiry sweep (FreshIndex.expire_ttl) and publish
        a new epoch if anything expired — the manual spelling of the
        `maintenance` policy's "sweep" task.  `now` overrides the
        monotonic clock the TTL deadlines are compared against (tests;
        None = time.monotonic()).  Returns the number of series
        expired.

        Concurrency: a writer on the writer lock, like delete().
        """
        with self._wlock:
            n = self._index.expire_ttl(now)
            if n:
                before = self._epoch
                self._publish()
                assert self._epoch > before, \
                    "TTL expiry must advance the snapshot epoch"
        return n

    def maintain(self) -> "QueryEngine":
        """Schedule every maintenance task the policy says is due, then
        drain the queue (flush) so they execute now on the calling
        thread.  A no-op without a `maintenance` policy.  Returns self.

        Concurrency: safe from any thread — scheduling registers journal
        parts under the condition variable; execution helps through the
        same journal machinery as flush().
        """
        self._schedule_maintenance()
        return self.flush()

    def compact(self) -> "QueryEngine":
        """Merge the delta into the core (incremental sorted-run merge —
        the stored core arrays are consumed as-is) and publish.
        Compacted epochs capture delta-free plans — steady-state cost
        returns to the core-only plan.  Returns self.

        Concurrency: a writer on the writer lock; readers keep draining
        old epochs while the merge runs outside the condition variable.
        """
        with self._wlock:
            self._compact_locked()
        return self

    def _compact_locked(self) -> None:
        """Heavy merge outside _cv, cheap commit + publish under it.
        Caller holds _wlock (no writer can race prepare -> commit).
        prepare_compact does ALL the heavy work (the merge), so
        commit_compact under _cv is a pointer swap and concurrent
        submit()/result() never stall behind a compaction."""
        token = self._index.prepare_compact()
        with self._cv:
            self._index.commit_compact(token)
            if token is not None:
                self._compactions += 1
        # the post-commit capture + publish run outside _cv (the caller
        # still holds _wlock, so no writer can slip between commit and
        # publish; readers keep draining previously published epochs)
        self._publish()

    def refresh(self) -> "QueryEngine":
        """Publish a snapshot of out-of-band index mutations (direct
        index.add()/compact() calls made without going through the
        engine).  Returns self.

        Concurrency: a writer — takes the writer lock like every other
        writer entry point, so a refresh cannot interleave with an
        in-flight prepare/commit compaction.
        """
        with self._wlock:
            self._publish()
        return self

    def recover(self, checkpoint: Optional[str] = None, *,
                step: Optional[int] = None, mesh=None,
                axis: Optional[str] = None) -> "QueryEngine":
        """Elastic shard recovery: re-place the index and publish.

        * TRANSIENT loss: a dispatch worker dies mid-batch.  Nothing to
          call: the orphaned batch is a WorkJournal part and any survivor
          (another worker, flush(), a blocked result() caller)
          re-executes it.
        * PERMANENT loss: a shard's device is gone.  With `checkpoint`
          the durable arrays of an `index.save()` directory replace the
          index's in place (`FreshIndex.reload`, unsharded), then the
          index is re-sharded over `mesh`; for an index that was
          sharded, `mesh` None means one row over every card still
          visible (`runtime.elastic.plan_serving_mesh`).  An index that
          was local stays local unless a mesh is passed.  Then a new
          epoch is published.

        In-flight futures are never dropped: batches formed before the
        recovery keep their submit-time Snapshot (the old placement) and
        complete on it; only post-recovery submits bind to the recovered
        epoch (fresh plans: the epoch and the placement key them).

        Args:
            checkpoint: `index.save()` directory to restore arrays from
                (None = keep the current in-memory arrays).
            step: checkpoint step (None = latest).
            mesh: target `runtime.sharding.Mesh` (None: see above).
            axis: mesh axis name (None = the index's current axis).
        Returns:
            self.
        Raises:
            TypeError: `mesh` is neither None nor a Mesh (before anything
                changes).
            ValueError: checkpoint config mismatch (FreshIndex.reload).
            RuntimeError: a sharded index, no mesh given, and no card
                left to build one from.

        Concurrency: a writer — serializes on the engine writer lock with
        add/compact/refresh; readers keep draining old epochs throughout.
        """
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a runtime.sharding.Mesh, got "
                            f"{type(mesh).__name__}")
        with self._wlock:
            ix = self._index
            axis = axis if axis is not None else ix.mesh_axis
            was_sharded = ix.mesh is not None
            if checkpoint is not None:
                ix.reload(checkpoint, step=step)
            if mesh is None and was_sharded:
                mesh = plan_serving_mesh(axis=axis).make()
            if mesh is not None:
                ix.shard(mesh, axis=axis)
            with self._cv:
                self._recoveries += 1
            self._publish()
        return self

    # ------------------------------------------------------------------ #
    # query path
    # ------------------------------------------------------------------ #
    def _tier_for(self, priority: str, k: int):
        """(knobs, tier_label) the `priority` class serves `k` with:
        the engine's exact Knobs by default, or — when
        `EngineConfig.latency_tiers` maps the class to a recall target —
        a twin Knobs carrying the calibrated stop rule for (k, target).

        Raises ValueError (via FreshIndex.resolve_stop_rule) when the
        target has no calibration entry: an uncalibrated approx tier
        must fail the submit loudly, not silently serve exact.

        Concurrency: reads calibration state without engine locks (the
        table is replaced wholesale by calibrate(), never mutated);
        `_tier_recall` writes race benignly (same value)."""
        spec = self._tiers.get(priority)
        if spec is None or spec == "exact":
            return self._knobs, "exact"
        target = float(spec)
        rule = self._index.resolve_stop_rule("approx", k=k,
                                             recall_target=target)
        label = f"approx@{target:g}"
        entry = self._index.calibration.lookup(k, target)
        if entry is not None:
            self._tier_recall[label] = entry.recall
        return (dataclasses.replace(self._knobs, stop_eps=float(rule.eps),
                                    stop_leaves=rule.max_leaves), label)

    def _tier_note(self, tier: str) -> dict:
        """The per-tier counter dict for `tier` (created on first use).
        Concurrency: callers hold _cv."""
        st = self._tier_stats.get(tier)
        if st is None:
            st = {"queries": 0, "batches": 0, "early_stops": 0,
                  "visited_leaves": 0.0, "visited_n": 0,
                  "latencies": deque(maxlen=self.config.latency_window)}
            self._tier_stats[tier] = st
        return st

    def submit(self, queries, k: int = 1, *,
               priority: str = "interactive",
               deadline_ms: Optional[float] = None) -> SearchFuture:
        """Enqueue `queries` — one (L,) query or an (m, L) batch — for
        top-`k` search on the CURRENT epoch; returns a SearchFuture.

        `priority` is the admission class ("interactive" or "batch"):
        when a `max_pending` budget is set, queued batch work is evicted
        first so interactive work admits.  `deadline_ms` bounds QUEUE
        time — a query still unformed after that many milliseconds
        expires and its future raises DeadlineExceeded (a formed batch
        always completes).  Rows already in the result cache for this
        epoch are served immediately, bit-identical to a cold plan
        execution, and consume no admission budget.

        Raises:
            ValueError: shape mismatch, empty batch, k < 1 or k beyond
                the snapshot's series count (mirrors FreshIndex.search),
                unknown priority, or deadline_ms <= 0.
            RuntimeError: the engine is closed.
            AdmissionError: the pending-queue budget is exhausted and
                overflow_policy is "shed" (the query was never queued).

        Concurrency: a reader; lock-held work is O(1) bookkeeping plus
        O(rows) cache dict lookups and O(evicted) shedding — query
        hashing runs BEFORE the lock — so submits never wait on
        compactions or plan captures.
        """
        if isinstance(queries, torch.Tensor):
            queries = queries.detach().cpu().numpy()
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        if priority not in _PRIORITIES:
            raise ValueError(f"priority must be one of {_PRIORITIES}, "
                             f"got {priority!r}")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0 or None, "
                             f"got {deadline_ms}")
        fps = None
        if self._cache is not None and q.ndim == 2 and q.shape[0] >= 1:
            fps = [query_fingerprint(row) for row in q]
        # quality-tier resolution runs BEFORE the lock (a table lookup +
        # one frozen-dataclass clone); an uncalibrated tier raises here,
        # before anything is enqueued
        knobs, tier = self._tier_for(priority, k)
        sync_point("engine.submit")
        shed_exc: Optional[Exception] = None
        with self._cv:
            if self._closed:
                raise RuntimeError("engine is closed")
            snap = self._snapshots[self._epoch]
            if q.ndim != 2 or q.shape[0] < 1 \
                    or q.shape[1] != snap.series_len:
                raise ValueError(
                    f"queries must be (m >= 1, {snap.series_len}), got "
                    f"shape {np.shape(queries)}")
            if k < 1:
                raise ValueError(f"k must be >= 1, got {k}")
            if k > snap.n_total:
                raise ValueError(f"k={k} exceeds the {snap.n_total} "
                                 f"indexed series")
            now = time.monotonic()
            fut = SearchFuture(self, q.shape[0], k, self._epoch, now)
            if self._first_submit is None:
                self._first_submit = now
            # 1. consult the epoch-keyed result cache, row by row
            missed = list(range(q.shape[0]))
            if fps is not None:
                missed = []
                for r, fp in enumerate(fps):
                    ent = self._cache.get(
                        (fp, self._epoch) + plan_key(k, knobs))
                    if ent is None:
                        missed.append(r)
                        continue
                    observe("engine.cache.hit",
                            (fut, self._epoch, k, q[r], ent[0], ent[1]))
                    self._tier_note(tier)["queries"] += 1
                    if fut._fill(r, ent[0][None], ent[1][None], now):
                        self._latencies.append(now - fut.submitted_at)
                        self._tier_note(tier)["latencies"].append(
                            now - fut.submitted_at)
                        self._completed += 1
            if not missed:
                return fut
            # 2. admission control over the rows actually enqueued
            deadline = (None if deadline_ms is None
                        else now + deadline_ms / 1e3)
            shed_exc, deadline = self._admit_locked(
                priority, len(missed), deadline, now)
            if shed_exc is None:
                for r0, r1 in _runs(missed):
                    self._pending.append(Pending(
                        q[r0:r1], k, self._epoch, fut, now,
                        deadline=deadline, row0=r0, priority=priority,
                        knobs=knobs, tier=tier))
                self._cv.notify_all()
            else:
                self._shed += 1
                self._shed_rows += len(missed)
                fut._fail(shed_exc, now)
                observe("engine.shed", (fut, priority, len(missed)))
        if shed_exc is not None:
            sync_point("engine.shed")
            raise shed_exc
        return fut

    def _admit_locked(self, priority: str, rows: int,
                      deadline: Optional[float], now: float):
        """Admission decision under _cv.  Returns (exc, deadline): exc
        is the AdmissionError to shed with (None = admitted), deadline
        is the possibly-tightened absolute deadline (overflow_policy
        "deadline" stamps over-budget submits instead of shedding)."""
        cfg = self.config
        over = False
        cls_cap = (cfg.max_pending_per_class or {}).get(priority)
        if cls_cap is not None:
            queued_cls = sum(p.queries.shape[0] for p in self._pending
                             if p.priority == priority)
            over = queued_cls + rows > cls_cap
        if not over and cfg.max_pending is not None:
            queued = sum(p.queries.shape[0] for p in self._pending)
            if queued + rows > cfg.max_pending:
                if priority == "interactive":
                    queued -= self._evict_batch_locked(
                        queued + rows - cfg.max_pending, now)
                over = queued + rows > cfg.max_pending
        if not over:
            return None, deadline
        if cfg.overflow_policy == "deadline":
            cap = now + cfg.overflow_deadline_ms / 1e3
            self._overflow_queued += 1
            return None, cap if deadline is None else min(deadline, cap)
        return AdmissionError(
            f"pending-queue budget exhausted ({rows} rows refused, "
            f"priority={priority!r}, max_pending={cfg.max_pending}, "
            f"per_class={cfg.max_pending_per_class})"), deadline

    def _evict_batch_locked(self, need: int, now: float) -> int:
        """Evict queued batch-priority submits (newest first — least
        time invested) to free >= `need` rows for an interactive
        arrival; returns rows freed.  Every pending slice of a victim
        future is removed and the future terminally fails with
        AdmissionError, so an evicted query can never also deliver."""
        victims: set = set()
        freed = 0
        for p in reversed(self._pending):
            if freed >= need:
                break
            if p.priority == "batch":
                victims.add(id(p.future))
                freed += p.queries.shape[0]
        if not victims:
            return 0
        kept, dropped = [], []
        for p in self._pending:
            (dropped if id(p.future) in victims else kept).append(p)
        self._pending = kept
        freed = 0
        failed: set = set()
        for p in dropped:
            freed += p.queries.shape[0]
            if id(p.future) in failed:
                continue
            failed.add(id(p.future))
            if p.future._fail(AdmissionError(
                    "evicted from the pending queue to admit "
                    "interactive work (max_pending budget)"), now):
                self._evicted_batch += 1
            observe("engine.shed",
                    (p.future, "batch", p.queries.shape[0]))
        return freed

    def flush(self) -> "QueryEngine":
        """Dispatch everything now: form pending into batches, schedule
        any due maintenance, then run every unfinished journal part —
        including orphaned batches (or maintenance tasks) whose worker
        died (helping).  Returns self once the queue is drained.

        Concurrency: safe from any thread; executes plans on the calling
        thread and races benignly with live workers (a lost race is
        detected via the journal's done flags).
        """
        self._form_and_register()
        self._schedule_maintenance()
        while True:
            sync_point("engine.flush.help")
            pid = self._next_part(worker=HELPER_ID, force_help=True)
            if pid is None:
                return self
            self._execute_part(pid, worker=HELPER_ID)

    def warmup(self, ks: Optional[Sequence[int]] = None,
               buckets: Optional[Sequence[int]] = None) -> "QueryEngine":
        """Capture plans for the current snapshot so first requests pay
        no capture.  `ks` defaults to config.warm_ks, `buckets` to every
        micro-batcher bucket; k values beyond the indexed series count
        are skipped.  Returns self.

        Concurrency: captures outside the engine locks; safe to run
        while traffic flows (concurrent submits may pay the capture
        inline for a bucket warmed a moment later).
        """
        ks = tuple(ks) if ks is not None else self.config.warm_ks
        buckets = (tuple(buckets) if buckets is not None
                   else self._batcher.buckets)
        with self._cv:
            snap = self._snapshots[self._epoch]
        for k in ks:
            if k > snap.n_total:
                continue
            # one plan per distinct tier Knobs: the exact tier plus any
            # calibrated approx tiers (an uncalibrated (k, target) pair
            # is skipped — submit will raise for it anyway)
            knob_set = {self._knobs}
            for priority in self._tiers:
                try:
                    knob_set.add(self._tier_for(priority, k)[0])
                except ValueError:
                    continue
            for b in buckets:
                for kn in knob_set:
                    self.plans.get(snap, b, k, kn)
        return self

    # ------------------------------------------------------------------ #
    # dispatch internals
    # ------------------------------------------------------------------ #
    def _form_and_register(self) -> int:
        """Drain pending into journal-registered batches; returns count.
        The journal state is captured under _cv (self-consistent) and
        flushed to disk AFTER _cv is released (no I/O under the cv)."""
        sync_point("engine.form")
        with self._cv:
            if not self._pending:
                return 0
            pending, self._pending = self._pending, []
            now = time.monotonic()
            live = []
            expired_futs: dict = {}
            for p in pending:
                if p.deadline is not None and p.deadline <= now:
                    expired_futs.setdefault(id(p.future), p)
                else:
                    live.append(p)
            for p in expired_futs.values():
                if p.future._fail(DeadlineExceeded(
                        f"query expired in the pending queue before "
                        f"forming (priority={p.priority!r})"), now):
                    self._deadline_expired += 1
                observe("engine.expire", (p.future, p.priority))
            batches = self._batcher.form(live, now)
            for b in batches:
                b.part_id = self._journal.add_part()
                self._batches[b.part_id] = b
                self._padded_slots += b.padded_slots
            n = len(batches)
            jstate = self._journal.snapshot()
        self._journal.persist(jstate)
        return n

    # ------------------------------------------------------------------ #
    # policy-driven maintenance (repro_torch.maintenance)
    # ------------------------------------------------------------------ #
    def _sample_state(self) -> MaintenanceState:
        """One observation for MaintenancePolicy.due — host ints/floats
        only.  Racy reads of index counters are fine here: a stale
        sample can only delay or duplicate a SCHEDULING decision, and
        execution re-reads the live index under the writer lock."""
        ix = self._index
        now = time.monotonic()
        return MaintenanceState(
            n_base=ix._n_base, delta_rows=ix.n_pending,
            dead_rows=ix.n_deleted, ttl_entries=ix.n_ttl,
            oldest_tombstone_age_s=ix.tombstone_age_s,
            since_sweep_s=now - self._last_sweep,
            since_checkpoint_s=now - self._last_checkpoint)

    def _maintenance_due(self) -> bool:
        """Cheap mutation-free check idle workers poll under _cv."""
        if self._policy is None:
            return False
        return any(k not in self._maint_inflight
                   for k in self._policy.due(self._sample_state()))

    def _schedule_maintenance(self) -> int:
        """Register one journal part per due task kind; returns how many
        were scheduled.  A kind already in flight is not re-scheduled
        (exactly one live part per kind), but a part whose executor died
        stays in the journal and is helped via the normal owner-dead
        steal — a dead maintainer delays maintenance by one backoff,
        never wedges it."""
        if self._policy is None:
            return 0
        with self._cv:
            due = [k for k in self._policy.due(self._sample_state())
                   if k not in self._maint_inflight]
            for kind in due:
                pid = self._journal.add_part()
                self._maint_parts[pid] = kind
                self._maint_inflight.add(kind)
                observe("engine.maint.schedule", (pid, kind))
            if not due:
                return 0
            jstate = self._journal.snapshot()
        self._journal.persist(jstate)
        return len(due)

    def _execute_maintenance(self, pid: int, kind: str, worker: int
                             ) -> None:
        """Run one maintenance part.  At-least-once like batch parts —
        every kind is idempotent to re-execution (a second sweep finds
        nothing expired, a second compact finds nothing pending, a
        checkpoint overwrites its own step atomically), and delivery is
        guarded by the journal's done flag so the bookkeeping commits
        exactly once."""
        sync_point("engine.maint.run", pid)
        if kind == "sweep":
            with self._wlock:
                n = self._index.expire_ttl()
                if n:
                    self._publish()
        elif kind == "compact":
            with self._wlock:
                self._compact_locked()
        elif kind == "checkpoint":
            with self._wlock:
                # step = current epoch: re-execution by a helper lands on
                # the same step and save_checkpoint's tmp+rename makes
                # the overwrite atomic + idempotent
                self._index.save(self._policy.checkpoint_dir,
                                 step=self._epoch)
        now = time.monotonic()
        sync_point("engine.maint.deliver", pid)
        with self._cv:
            if self._journal.is_done(pid):   # a racing helper beat us
                return
            self._journal.mark_done(pid)
            self._maint_counts[kind] = self._maint_counts.get(kind, 0) + 1
            self._maint_parts.pop(pid, None)
            self._maint_inflight.discard(kind)
            if kind == "sweep":
                self._last_sweep = now
            elif kind == "checkpoint":
                self._last_checkpoint = now
            self._journal.prune_done()
            jstate = self._journal.snapshot()
            self._cv.notify_all()
        self._journal.persist(jstate)

    def _next_part(self, worker: int, force_help: bool = False
                   ) -> Optional[int]:
        """Acquire the next unowned part, else steal an orphan.

        Stealing honours the paper's backoff rule (help only after the
        owner exceeds the measured-T_avg deadline) unless the owner
        thread is provably dead or `force_help` (flush) is set."""
        got: Optional[int] = None
        jstate = None
        with self._cv:
            pid = self._journal.acquire(worker)
            if pid is not None:
                got = pid
            else:
                now = time.time()
                ddl = self._journal.backoff_deadline()
                for pid in self._journal.unfinished():
                    p = self._journal.part(pid)
                    # Never re-steal our own in-flight part — EXCEPT under
                    # force_help, where "our" id is the shared HELPER_ID:
                    # skipping would let one helper stalled mid-part wedge
                    # every other flush()/result() forever (no live worker
                    # exists in sync mode to age-out the orphan).  Racing
                    # a live helper on the same part is benign: execution
                    # is idempotent and delivery is guarded by is_done.
                    if p.owner == worker and not force_help:
                        continue
                    owner_dead = (0 <= p.owner < len(self._workers)
                                  and not self._workers[p.owner].is_alive())
                    if (force_help or owner_dead
                            or (now - p.acquired_at) > ddl):
                        self._journal.steal(pid, worker)
                        got = pid
                        break
            if got is not None:
                jstate = self._journal.snapshot()
        if got is not None:
            self._journal.persist(jstate)   # outside _cv: no I/O under it
        return got

    def _execute_part(self, pid: int, worker: int) -> None:
        """Run one journal part: a query batch through its snapshot's
        plan, or a maintenance task (the part_id -> kind map).
        Pure + idempotent either way: a helper re-executing an orphan
        recomputes identical rows / re-runs an idempotent task."""
        with self._cv:
            if self._journal.is_done(pid):
                return
            # maintenance parts are routed FIRST: they are never in
            # _batches, so the reloaded-part discard below must not see
            # them
            kind = self._maint_parts.get(pid)
            batch = None if kind is not None else self._batches.get(pid)
            if kind is None and batch is None:
                # Unfinished in the journal yet no in-memory batch: the
                # part was reloaded from a crashed process — its batch
                # and futures died there, so nothing can ever be
                # delivered.  Retire it, or force_help would re-steal it
                # every iteration and flush() / a sync-mode result()
                # would livelock.  __init__ already retires reloaded
                # parts; this guard keeps the invariant local.
                self._journal.discard(pid)
                self._journal.prune_done()
                jstate = self._journal.snapshot()
            elif batch is not None:
                snap = self._snapshots[batch.epoch]
        if kind is not None:
            self._execute_maintenance(pid, kind, worker)
            return
        if batch is None:
            self._journal.persist(jstate)
            return
        # mid-flight window (no locks held): a worker stalled or crashed
        # anywhere from here to the delivery block below leaves an
        # orphaned part any helper can re-execute — the checker's
        # lock-freedom scenarios stall threads exactly here
        sync_point("engine.execute.run", pid)
        if self._crash_hook is not None:
            self._crash_hook(worker, batch)      # may raise WorkerCrash
        knobs = batch.knobs if batch.knobs is not None else self._knobs
        plan = self.plans.get(snap, batch.queries.shape[0], batch.k,
                              knobs)
        # a graph is not reentrant: a helper that stole this batch waits
        # on the plan's lock for the owner's run and takes that run's
        # result (the plan remembers its last part id) instead of
        # replaying it
        d, i, rounds = plan.run(batch.queries, token=pid)
        if snap.id_alias:
            # rows renamed by update() answer under their stable public
            # id; the remap uses the alias view frozen at this batch's
            # submit epoch
            i = i.copy()
            for internal, stable in snap.id_alias:
                i[i == internal] = stable
        # visited-leaf accounting for the quality tier counters: the
        # round loop refines round_leaves per round, capped by the PQ
        # budget and the tier's stop_leaves (each shard's own, on a
        # sharded snapshot)
        n_shards = 1 if snap.shards is None else len(snap.shards)
        budget = exact_budget = int(snap.core.n_leaves) // n_shards
        if knobs.pq_budget is not None:
            budget = exact_budget = min(budget, knobs.pq_budget)
        if knobs.stop_leaves is not None:
            budget = min(budget, knobs.stop_leaves)
        visited = n_shards * min(rounds * knobs.round_leaves, budget)
        early_stop = (batch.tier != "exact"
                      and visited < n_shards * exact_budget)
        # fingerprint the real query rows OUTSIDE the locks — hashing is
        # the only non-O(1) part of the cache fill below
        fps = None
        if self._cache is not None:
            fps = {dst + j: query_fingerprint(batch.queries[dst + j])
                   for _, dst, _, n in batch.segments for j in range(n)}
        now = time.monotonic()
        sync_point("engine.execute.deliver", pid)
        with self._cv:
            if self._journal.is_done(pid):       # a racer beat us (and may
                return                           # have pruned the part)
            self._journal.mark_done(pid)
            self._dispatched += 1
            self._rounds_sum += rounds * batch.n_real
            self._rounds_n += batch.n_real
            tstats = self._tier_note(batch.tier)
            tstats["queries"] += batch.n_real
            tstats["batches"] += 1
            tstats["visited_leaves"] += visited * batch.n_real
            tstats["visited_n"] += batch.n_real
            if early_stop:
                tstats["early_stops"] += batch.n_real
            for fut, dst, src, n in batch.segments:
                if fps is not None:
                    for j in range(n):
                        key = ((fps[dst + j], batch.epoch)
                               + plan_key(batch.k, knobs))
                        self._cache.put(key, d[dst + j], i[dst + j])
                        observe("engine.cache.fill",
                                (key, batch.epoch, batch.k,
                                 batch.queries[dst + j],
                                 d[dst + j], i[dst + j]))
                if fut._fill(src, d[dst:dst + n], i[dst:dst + n], now):
                    self._latencies.append(now - fut.submitted_at)
                    tstats["latencies"].append(now - fut.submitted_at)
                    self._completed += 1
            del self._batches[pid]
            # release the done prefix so journal scans and memory stay
            # O(in-flight batches) on an endless request stream
            self._journal.prune_done()
            jstate = self._journal.snapshot()
            dead = self._gc_snapshots()
            self._cv.notify_all()
        self._journal.persist(jstate)    # durability flush outside _cv
        # the dead epochs' plans (graphs, their memory pools) go outside
        # _cv too
        self.plans.drop_epochs(dead)

    def _gc_snapshots(self) -> list:
        """Drop the snapshots no pending query or in-flight batch reads
        (the current epoch always stays); returns their epochs, whose
        plans the caller drops after releasing _cv.  Caller holds _cv."""
        live = {self._epoch}
        live.update(p.epoch for p in self._pending)
        live.update(b.epoch for b in self._batches.values())
        dead = [e for e in self._snapshots if e not in live]
        for e in dead:
            del self._snapshots[e]
        if dead:
            observe("engine.gc", tuple(dead))
        return dead

    def has_live_workers(self) -> bool:
        """True while at least one dispatch worker thread is alive.

        Concurrency: lock-free racy read — a worker may die right after;
        callers (result's helping loop) tolerate staleness either way.
        """
        return any(t.is_alive() for t in self._workers)

    def _make_progress(self) -> None:
        """One helping step for a blocked result() caller."""
        sync_point("engine.help")
        if not self.has_live_workers():
            self.flush()
            return
        # workers alive: only pick up genuinely orphaned/expired work
        self._form_and_register()
        self._schedule_maintenance()
        pid = self._next_part(worker=HELPER_ID)
        if pid is not None:
            self._execute_part(pid, worker=HELPER_ID)

    def _worker_loop(self, wid: int) -> None:
        linger = self.config.linger_ms / 1e3
        try:
            while True:
                with self._cv:
                    # the idle wait also polls the maintenance policy:
                    # a due task breaks the wait so the worker can
                    # schedule + execute it (scheduling itself happens
                    # below, outside the wait, because registering parts
                    # persists the journal — no I/O under _cv)
                    while (not self._pending and not self._closed
                           and not self._journal.unfinished()
                           and not self._maintenance_due()):
                        self._cv.wait(timeout=0.05)
                    if (self._closed and not self._pending
                            and not self._journal.unfinished()):
                        return
                    if self._pending and linger > 0:
                        deadline = time.monotonic() + linger
                        # deadline-aware early close: stop waiting for
                        # the padding bucket to fill once the oldest
                        # queued deadline is (nearly) due — dispatch a
                        # partial bucket instead of expiring the query
                        edl = earliest_deadline(self._pending)
                        if edl is not None:
                            deadline = min(deadline, edl - 1e-3)
                        while (sum(p.queries.shape[0]
                                   for p in self._pending)
                               < self.config.max_batch):
                            left = deadline - time.monotonic()
                            if left <= 0:
                                break
                            self._cv.wait(timeout=left)
                self._form_and_register()
                self._schedule_maintenance()
                while True:
                    pid = self._next_part(wid)
                    if pid is None:
                        break
                    self._execute_part(pid, wid)
        except WorkerCrash:
            with self._cv:
                self._crashed_workers += 1
                self._cv.notify_all()

    # ------------------------------------------------------------------ #
    # lifecycle / stats
    # ------------------------------------------------------------------ #
    def close(self, drain: bool = True) -> None:
        """Stop the engine; `drain` first completes everything queued.

        Concurrency: idempotent; joins worker threads (10 s cap each).
        Submits racing close() either land before the closed flag or
        raise RuntimeError — no future is silently dropped.
        """
        if drain and not self._closed:
            self.flush()
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        for t in self._workers:
            t.join(timeout=10)

    def __enter__(self) -> "QueryEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=exc[0] is None)

    def stats(self) -> dict:
        """Serving telemetry: queue depth, latency percentiles (ms),
        rounds-per-query, epoch lag, recoveries, plan-cache and batching
        counters, plus the overload counters (shed / evicted_batch /
        overflow_queued / deadline_expired), the result_cache
        hit/miss/fill/eviction rates and the mesh (None when local, else
        its axes and its slot count): repro's keys.

        Concurrency: takes the condition variable briefly for one
        consistent cut; safe from any thread at any rate.
        """
        # freshness first, OUTSIDE _cv: the first check per lifecycle
        # version hashes index arrays (a blocking device->host pull that
        # must not run under the condition variable)
        calibrated = getattr(self._index, "calibration", None) is not None
        calib_fresh = (self._index.is_calibration_fresh()
                       if calibrated else False)
        with self._cv:
            lat = sorted(self._latencies)
            inflight = len(self._batches)
            epochs = ([p.epoch for p in self._pending]
                      + [b.epoch for b in self._batches.values()])
            oldest = min(epochs) if epochs else self._epoch
            elapsed = (time.monotonic() - self._first_submit
                       if self._first_submit is not None else 0.0)
            js = self._journal.stats()
            mesh = self._snapshots[self._epoch].mesh
            return {
                "epoch": self._epoch,
                "epoch_lag": self._epoch - oldest,
                "compactions": self._compactions,
                "recoveries": self._recoveries,
                "queue_depth": len(self._pending),
                "queued_rows": sum(p.queries.shape[0]
                                   for p in self._pending),
                "inflight_batches": inflight,
                "completed": self._completed,
                "qps": (self._completed / elapsed if elapsed > 0 else 0.0),
                "latency_ms": {
                    "n": len(lat),
                    "p50": _pctl(lat, 0.50) * 1e3,
                    "p99": _pctl(lat, 0.99) * 1e3,
                    "mean": (sum(lat) / len(lat) * 1e3 if lat else 0.0),
                },
                "rounds_per_query": (self._rounds_sum / self._rounds_n
                                     if self._rounds_n else 0.0),
                "mesh": (None if mesh is None else
                         {"axes": dict(mesh.shape), "devices": mesh.size}),
                "maintenance": {
                    "policy": (None if self._policy is None
                               else self._policy.freshness.name),
                    "sweeps": self._maint_counts["sweep"],
                    "compacts": self._maint_counts["compact"],
                    "checkpoints": self._maint_counts["checkpoint"],
                    "pending_tasks": len(self._maint_parts),
                    "deleted": self._index.n_deleted,
                    "ttl_entries": self._index.n_ttl,
                },
                "overload": {
                    "shed": self._shed,
                    "shed_rows": self._shed_rows,
                    "evicted_batch": self._evicted_batch,
                    "overflow_queued": self._overflow_queued,
                    "deadline_expired": self._deadline_expired,
                },
                "quality": {
                    "tiers": {
                        tier: {
                            "queries": st["queries"],
                            "batches": st["batches"],
                            "early_stops": st["early_stops"],
                            "visited_leaves_per_query": (
                                st["visited_leaves"] / st["visited_n"]
                                if st["visited_n"] else 0.0),
                            "advertised_recall": self._tier_recall.get(
                                tier),
                            "latency_ms": {
                                "n": len(st["latencies"]),
                                "p50": _pctl(sorted(st["latencies"]),
                                             0.50) * 1e3,
                                "p99": _pctl(sorted(st["latencies"]),
                                             0.99) * 1e3,
                            },
                        } for tier, st in self._tier_stats.items()},
                    "latency_tiers": dict(self._tiers),
                    "calibrated": calibrated,
                    "calibration_fresh": calib_fresh,
                },
                "result_cache": (self._cache.stats() if self._cache
                                 is not None else
                                 {"hits": 0, "misses": 0, "fills": 0,
                                  "evictions": 0, "entries": 0,
                                  "capacity": 0}),
                "plan_cache": self.plans.stats(),
                "batches": {
                    "dispatched": self._dispatched,
                    "padded_slots": self._padded_slots,
                    "helped": js["helped"],
                    "parts": js["n_parts"],
                },
                "workers": {"configured": self.config.workers,
                            "live": sum(t.is_alive()
                                        for t in self._workers),
                            "crashed": self._crashed_workers},
            }

    def __repr__(self) -> str:
        return (f"QueryEngine(epoch={self._epoch}, "
                f"buckets={self._batcher.buckets}, "
                f"workers={self.config.workers}, "
                f"graphs={self.plans.donate})")


def _runs(rows) -> list:
    """Contiguous (start, stop) runs of an ascending row-index list —
    one Pending per run when a submit partially hits the result cache."""
    out: list = []
    for r in rows:
        if out and out[-1][1] == r:
            out[-1][1] = r + 1
        else:
            out.append([r, r + 1])
    return [(a, b) for a, b in out]


def _pctl(sorted_vals, p: float) -> float:
    """Nearest-rank percentile of an ascending list (0.0 when empty)."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(p * len(sorted_vals))))
    return sorted_vals[idx]
