"""PlanCache: one captured search plan per (bucket, k, knobs, epoch).

The port's counterpart of `repro.serve.plan_cache`.  repro compiles each
bucket's executable ahead of time (`jax.jit(...).lower(...).compile()`)
so that steady-state dispatch never re-traces.  Here a plan on the card
is ONE CUDA graph (`torch.cuda.CUDAGraph`): the whole local search of a
batch (`core.search.view_search_device`: the query summarize, the
lower-bound kernel, the PQ sort, the one `refine_search` launch, the
re-rank, and with a pending delta its exact scan and merge) captured once
and replayed per batch, so a dispatch costs one graph launch and the
copies in and out instead of the dozens of launches the eager search
makes from the host.

A graph reads the addresses it captured, where an XLA executable takes
its arrays as runtime arguments.  So the key carries the EPOCH (repro
keys on the snapshot's shapes and reuses an executable across epochs),
a plan holds the snapshot whose tensors it read (they stay alive as long
as the plan does), and the engine drops an epoch's plans when it drops
the epoch.  A publish therefore costs at most one capture per (bucket,
k, knobs) that later traffic uses, and misses stay frozen after
`warmup()` within an epoch (tests/test_torch_serve.py).

Each plan has a static (bucket_q, L) float32 query buffer and static
(bucket_q, k) distance and id outputs and a (bucket_q,) round count, and
`run()` copies the padded batch in, replays, and copies the outputs out
under the plan's own lock: two workers replaying one graph would
overwrite each other's outputs, where an XLA executable is reentrant.
Capture warms the plan up eagerly once on a side stream first (which
also builds the kernel libraries: nvcc runs at first use, and must not
run inside a capture), and captures with `capture_error_mode=
"thread_local"`, so another thread's unrelated allocation does not break
it; captures run one at a time.  A failed capture raises; it never falls
back to the eager call.

Donation: `donate` keeps repro's name and auto rule (on for the
accelerator, off for the CPU) and means "the plan owns its device
buffers", i.e. the CUDA graph.  `donate=False` runs each batch through
the same function eagerly (on the card, the same kernels launch by
launch), which is what a CPU index always does: there a plan calls
exactly what `FreshIndex.search` calls, so engine rows are bit-identical
to the facade by construction.  `donate=True` on a CPU index raises.

A sharded snapshot gets a `ShardedCompiledPlan`: the sharded search
reads its loop condition on the host between chunks of rounds, which a
graph cannot hold, so it runs eagerly under the plan's lock and never
donates (as repro's sharded plans never do).  Its `core.search.
ShardedPlan` is made once per (mesh placement, axis, k, knobs) and
shared by every bucket and epoch (`stats()["sharded_traces"]` counts
them, repro's count of sharded tracings).
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Dict, Hashable, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.hooks import observe, sync_point
from repro_torch.core.search import (ShardedPlan, build_sharded_plan,
                                     sharded_view_search, view_search_device)

# one capture at a time in the process: a capture synchronizes the
# device and empties the allocator's cache first, which must not run
# while another thread's capture is open
_CAPTURE_LOCK = threading.Lock()

# how long a thread waiting for another's capture of its key blocks
# between two `plan_cache.get.wait` seams
_WAIT_S = 0.005


@dataclasses.dataclass(frozen=True)
class Knobs:
    """The fully-resolved search knobs one batch serves with (the exact
    tier's Knobs are resolved once at engine construction from
    EngineConfig -> IndexConfig -> the index's autotune table; approx
    tiers get a twin with the stop-rule fields filled in from the
    calibration table).  `sync_every` is the sharded plans' rounds
    between two publications of the global k-th bound; local plans
    ignore it.  `stop_eps` /
    `stop_leaves` are the approximate-search early-termination knobs
    (`quality.StopRule.lower()`); their defaults are the exact plan.
    repro's `backend`, `dma_depth` and `block_q` are Pallas structure
    knobs and have no counterpart here."""
    round_leaves: int = 8
    znorm: bool = True
    max_rounds: Optional[int] = None
    pq_budget: Optional[int] = None
    sync_every: int = 1
    stop_eps: float = 0.0
    stop_leaves: Optional[int] = None


def plan_key(k: int, knobs: Knobs) -> tuple:
    """EVERY search-semantics knob of a (k, knobs) request as one flat
    tuple — the single key-derivation helper both caches build on.
    `ResultCache` keys are `(fingerprint, epoch) + plan_key(...)` and
    `PlanCache` keys are `(bucket_q, epoch) + plan_key(...)`, so a knob
    added to `Knobs` automatically keys BOTH caches (the key length
    tracks `dataclasses.fields(Knobs)`)."""
    return (int(k),) + dataclasses.astuple(knobs)


class CompiledPlan:
    """One plan of fixed (bucket_q, k, knobs, snapshot): `run(queries)`
    -> (dist (bucket_q, k), ids (bucket_q, k), rounds), numpy rows and
    the batch's round count (the most any query ran), ids internal
    (before the snapshot's update aliases).

    `graph` is the captured CUDA graph, or None for an eager plan (a CPU
    index, or `donate=False`).  `calls` counts runs: a replay passes
    through no kernel wrapper, so the wrappers' launch counts miss it."""

    __slots__ = ("snapshot", "bucket_q", "k", "knobs", "graph", "calls",
                 "_fn", "_q", "_out", "_lock", "_last")

    def __init__(self, snapshot, bucket_q: int, k: int, knobs: Knobs,
                 capture: bool):
        self.snapshot = snapshot
        self.bucket_q = bucket_q
        self.k = k
        self.knobs = knobs
        self.calls = 0
        self._fn = functools.partial(
            view_search_device, snapshot.core, snapshot.delta_rows,
            snapshot.delta_alive, snapshot.n_base, k=k, znorm=knobs.znorm,
            round_leaves=knobs.round_leaves, max_rounds=knobs.max_rounds,
            pq_budget=knobs.pq_budget, stop_eps=knobs.stop_eps,
            stop_leaves=knobs.stop_leaves)
        self._lock = threading.Lock()
        self._last = (None, None)      # (token, result) of the last run
        self.graph = self._q = self._out = None
        if capture:
            self._capture()

    def _warm_rows(self) -> torch.Tensor:
        """Queries for the eager warm-up run: stored rows of the
        snapshot (each finds itself at once), repeated to the bucket."""
        snap = self.snapshot
        src = snap.core.series if snap.core.series.shape[0] else \
            snap.delta_rows
        if src is None or src.shape[0] == 0:
            return torch.zeros_like(self._q)
        rows = torch.arange(self.bucket_q, device=src.device) % src.shape[0]
        return src[rows].float()

    def _capture(self) -> None:
        series = self.snapshot.core.series
        dev = series.device
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA index, not {dev}")
        with _CAPTURE_LOCK, torch.cuda.device(dev):
            self._q = torch.empty((self.bucket_q, series.shape[1]),
                                  dtype=torch.float32, device=dev)
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._q.copy_(self._warm_rows())
                self._fn(self._q)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._out = self._fn(self._q)
        self.graph = graph

    def run(self, queries: np.ndarray, token: Optional[Hashable] = None
            ) -> Tuple[np.ndarray, np.ndarray, int]:
        """The plan on one padded (bucket_q, L) float32 batch: copy it
        in, replay (or run eagerly), copy the outputs out, all under
        this plan's lock.  `token` names the batch (the engine's journal
        part): a run whose token is the last completed run's returns
        that run's host arrays without running again, so a helper that
        waited on the lock for the owner's run of the same batch takes
        its result (and may deliver it, should the owner stall before
        delivery)."""
        with self._lock:
            if token is not None and self._last[0] == token:
                return self._last[1]
            self.calls += 1
            if self.graph is None:
                q = torch.as_tensor(queries, dtype=torch.float32,
                                    device=self.snapshot.core.series.device)
                d, i, rounds = self._fn(q)
            else:
                with torch.cuda.device(self._q.device):
                    self._q.copy_(torch.from_numpy(queries))
                    self.graph.replay()
                d, i, rounds = self._out
            if isinstance(rounds, torch.Tensor):    # each query's count
                rounds = rounds.cpu().numpy()
                rounds = int(rounds.max()) if rounds.size else 0
            out = (d.cpu().numpy(), i.cpu().numpy(), rounds)
            self._last = (token, out)
        return out


class ShardedCompiledPlan(CompiledPlan):
    """The plan of one (bucket_q, k, knobs, sharded snapshot), `run` as
    `CompiledPlan.run`: `core.search.sharded_view_search` (the sharded
    plan `plan` over the snapshot's masked shards, then the exact scan of
    its delta rows), the function the sharded `FreshIndex.search` runs,
    so the rows are the facade's.  It runs eagerly under the plan's
    lock: not captured as a CUDA graph (its loop reads the device
    between chunks of rounds), and it never donates."""

    __slots__ = ("plan",)

    def __init__(self, snapshot, bucket_q: int, k: int, knobs: Knobs,
                 plan: ShardedPlan):
        super().__init__(snapshot, bucket_q, k, knobs, capture=False)
        self.plan = plan
        self._fn = functools.partial(
            sharded_view_search, plan, snapshot.shards, snapshot.delta_rows,
            snapshot.delta_alive, snapshot.n_base, znorm=knobs.znorm)


class _Making:
    """One key's capture in flight: its waiters block on `done`, then
    take `plan` (None when the capture raised: they miss again)."""

    __slots__ = ("done", "plan")

    def __init__(self):
        self.done = threading.Event()
        self.plan: Optional[CompiledPlan] = None


class PlanCache:
    """(bucket_q, epoch, k, knobs, placement) -> CompiledPlan (or
    ShardedCompiledPlan), with counters."""

    def __init__(self, device: torch.device, donate: Optional[bool] = None):
        if donate is None:
            donate = device.type == "cuda"
        if donate and device.type != "cuda":
            raise ValueError(
                f"donate=True captures CUDA graphs; the index lives on "
                f"{device}, where plans run eagerly (donate=False or None)")
        self.donate = bool(donate)
        self.hits = 0
        self.misses = 0
        self._plans: Dict[Tuple, CompiledPlan] = {}
        self._dropped: set = set()     # epochs whose plans were dropped
        self._sharded: Dict[Tuple, ShardedPlan] = {}
        self._making: Dict[Tuple, _Making] = {}   # key -> capture in flight
        self._lock = threading.Lock()

    def get(self, snapshot, bucket_q: int, k: int,
            knobs: Knobs) -> CompiledPlan:
        """The plan for this bucket of this snapshot, captured on miss
        (outside the cache lock: a capture takes milliseconds to
        seconds).  One capture a key: the first thread to miss a key
        registers its capture, and threads that miss the same key while
        it runs wait for it and take its plan as a hit, so a publish
        captures at most once per (bucket, k, knobs) as repro compiles
        at most once.  The capture's entry leaves `_making` in the same
        critical section that stores the plan, so no thread can find
        neither a plan nor a capture in flight and capture again.

        Seams (`analysis.hooks.sync_point`, no lock held at any):
        `plan_cache.get.lookup` after the first lookup,
        `plan_cache.get.capture` before the capture,
        `plan_cache.get.store` between the capture and the store, and
        `plan_cache.get.wait` before each wait for another's capture."""
        key = ((bucket_q, snapshot.epoch) + plan_key(k, knobs)
               + (snapshot.placement,))
        while True:
            with self._lock:
                plan = self._plans.get(key)
                if plan is not None:
                    self.hits += 1
                    return plan
                making = self._making.get(key)
                mine = making is None
                if mine:
                    making = self._making[key] = _Making()
            sync_point("plan_cache.get.lookup", key)
            if mine:
                return self._make(key, making, snapshot, bucket_q, k, knobs)
            # another thread captures this key: wait for its plan, parking
            # at a seam between waits so that a race checker that holds
            # the capturer can run the waiter meanwhile
            while True:
                sync_point("plan_cache.get.wait", key)
                if making.done.wait(_WAIT_S):
                    break
            if making.plan is not None:
                with self._lock:
                    self.hits += 1
                return making.plan
            # that capture raised: miss again, and capture here

    def _make(self, key: tuple, making: "_Making", snapshot, bucket_q: int,
              k: int, knobs: Knobs) -> CompiledPlan:
        """Capture the plan of `key` (this thread registered `making`),
        store it and hand it to the threads waiting on `making`."""
        sync_point("plan_cache.get.capture", key)
        try:
            plan = self._construct(key, snapshot, bucket_q, k, knobs)
        except BaseException:
            with self._lock:
                self._making.pop(key, None)
            making.done.set()
            raise
        sync_point("plan_cache.get.store", key)
        with self._lock:
            self._making.pop(key, None)
            self.misses += 1
            # the epoch died while this capture ran (a helper that lost a
            # race, a warmup racing a publish): serve the caller and its
            # waiters, keep nothing
            if snapshot.epoch not in self._dropped:
                self._plans[key] = plan
        making.plan = plan
        making.done.set()
        return plan

    def _construct(self, key: tuple, snapshot, bucket_q: int, k: int,
                   knobs: Knobs) -> CompiledPlan:
        """Make the plan of `key`: capture it (or, for a sharded
        snapshot, set up its eager plan).  Reports each plan made to the
        race checker (`observe("plan_cache.make", key)`)."""
        if snapshot.mesh is not None:
            plan = ShardedCompiledPlan(snapshot, bucket_q, k, knobs,
                                       self._sharded_plan(snapshot, k, knobs))
        else:
            plan = CompiledPlan(snapshot, bucket_q, k, knobs, self.donate)
        observe("plan_cache.make", key)
        return plan

    def _sharded_plan(self, snapshot, k: int, knobs: Knobs) -> ShardedPlan:
        """The ShardedPlan of this (mesh placement, axis, k, knobs), made
        on first use under the cache lock, so racing buckets share one."""
        key = (snapshot.placement,) + plan_key(k, knobs)
        with self._lock:
            plan = self._sharded.get(key)
            if plan is None:
                plan = build_sharded_plan(
                    snapshot.mesh, axis=snapshot.mesh_axis, k=k,
                    round_leaves=knobs.round_leaves,
                    sync_every=knobs.sync_every,
                    max_rounds=knobs.max_rounds, znorm=knobs.znorm,
                    pq_budget=knobs.pq_budget, stop_eps=knobs.stop_eps,
                    stop_leaves=knobs.stop_leaves)
                self._sharded[key] = plan
            return plan

    def drop_epochs(self, epochs: Iterable[int]) -> list:
        """Remove the plans of `epochs` (their snapshots are gone) and
        return them: the caller releases the graphs and their memory
        pools by dropping the list, outside its own locks."""
        dead = set(epochs)
        with self._lock:
            self._dropped |= dead
            keys = [key for key in self._plans if key[1] in dead]
            return [self._plans.pop(key) for key in keys]

    def plans(self) -> list:
        """The live plans (for replay counts)."""
        with self._lock:
            return list(self._plans.values())

    def stats(self) -> dict:
        """Counters proving (or disproving) steady-state zero-capture:
        `misses` must freeze after warmup within an epoch; `size` counts
        live plans (graphs, when `donate` and the index is local);
        `sharded_traces` counts the distinct (mesh, k, knobs) sharded
        plans behind them."""
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "size": len(self._plans), "donate": self.donate,
                    "sharded_traces": len(self._sharded)}
