"""IndexBuilder: the phase-modular, Refresh-driven build (paper §IV-V).

The port's counterpart of `repro.core.builder`.  `build_index`
(core/index.py) builds in one pass over all rows; this is the
paper-shaped API:

    builder = IndexBuilder(IndexConfig(...), workers=4)
    builder.feed(chunk_a)            # streaming ingest: summarize/key/sort
    builder.feed(chunk_b)            #   run eagerly as blocks fill
    index = builder.finalize()       # merge runs -> leaf stats -> FlatIndex

Every phase is split into PARTS driven through a pluggable
`core.traverse.Executor`: `SequentialExecutor` (the single-shot oracle)
or `RefreshExecutor` (lock-free workers with owner/helper modes and
crash/delay injectors):

    summarize    per row-block, on the device: one launch of the summarize
                 kernel (z-norm -> PAA -> iSAX word -> ||x||^2, and the
                 float32 series), the same function `build_index` calls
    key          per row-block, on the host: the bit-interleaved sort key
                 (numpy, integer math)
    sort         per row-block, on the host: a stable lexsort -> one
                 sorted RUN per block
    merge        log2 levels of pairwise stable run merges on the host
                 (adjacent runs only, so stability == one global stable
                 sort)
    leaf_stats   per leaf-group, on the device: one launch of the
                 leaf_stats kernel (the function `build_index` calls)
    materialize  per row-block, on the device: one launch of the
                 leaf_gather kernel, which gathers the rows into the
                 padded, leaf-ordered FlatIndex arrays

Part boundaries depend only on `part_rows`, every payload writes
deterministic values into disjoint output slots, and a helper that
re-applies a part rewrites the same bytes.  The summarize kernel gives a
row the same bits whatever rows share its launch.  So a 4-worker build
under crash injectors, a chunked feed and `build_index` over the same
rows give bit-identical arrays.  Completion is guaranteed even if every
worker crashes: phases run through `traverse_complete`, where the calling
thread helps any part whose done flag never set.

`merge_sorted_delta` is the incremental compaction built from the same
phases (Jiffy's batch merge): the stored core arrays are kept as they are
(series, paa, words, sq_norms bit-preserved, never re-normalized or
re-rounded), only the delta is summarized and cast to the storage dtype,
once, and the two sorted runs merge stably.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from . import isax
from repro_torch.kernels import leaf_gather, leaf_stats
from repro_torch.kernels.isax_summarize import summarize_rows

from .index import STORAGE, FlatIndex
from .refresh import Injectors, RefreshExecutor
from .traverse import Executor, SequentialExecutor, traverse_complete

PHASES = ("summarize", "key", "sort", "merge", "leaf_stats", "materialize")


def _cat(blocks: List[torch.Tensor]) -> torch.Tensor:
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks)


def _merge_two_sorted(a_ids: np.ndarray, b_ids: np.ndarray,
                      a_keys: np.ndarray, b_keys: np.ndarray) -> np.ndarray:
    """Stable linear merge of two sorted runs: each of b's packed keys is
    binary-searched into a (side='right': a wins ties), then both id lists
    are scattered into their merged slots.  a's ids precede b's on equal
    keys, so merging adjacent runs composes to one global stable sort."""
    pos = np.searchsorted(a_keys, b_keys, side="right")
    out = np.empty(a_ids.shape[0] + b_ids.shape[0], np.int64)
    tgt_b = pos + np.arange(b_ids.shape[0])
    mask = np.ones(out.shape[0], bool)
    mask[tgt_b] = False
    out[mask] = a_ids
    out[tgt_b] = b_ids
    return out


def _finalize_from_order(series_src: torch.Tensor, paa: torch.Tensor,
                         words: torch.Tensor, sqn: torch.Tensor,
                         order: np.ndarray, perm_src: Optional[torch.Tensor],
                         config, run_phase: Callable[[str, int, Callable],
                                                     None],
                         part_rows: int) -> FlatIndex:
    """The leaf_stats and materialize phases over a merged global order.

    series_src, paa, words and sqn are SOURCE-ordered device tensors;
    `order` maps sorted position -> source row; `perm_src` maps source
    row -> series id (None: the source row is the id, a fresh build).
    Shared by `IndexBuilder.finalize` and `merge_sorted_delta`, so a
    compacted index and a fresh build cannot drift.
    """
    dev = series_src.device
    n = order.shape[0]
    M = config.leaf_capacity
    w = config.segments
    L = series_src.shape[1]
    maxsym = (1 << config.bits) - 1
    n_pad = -(-n // M) * M
    n_leaves = n_pad // M
    order_d = torch.from_numpy(order).to(dev)

    out_series = torch.zeros((n_pad, L), dtype=series_src.dtype, device=dev)
    out_paa = torch.full((n_pad, w), float("inf"), device=dev)
    out_words = torch.full((n_pad, w), maxsym, dtype=words.dtype, device=dev)
    out_sqn = torch.full((n_pad,), 1e30, device=dev)
    out_perm = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
    stats = (torch.empty((n_leaves, w), device=dev),
             torch.empty((n_leaves, w), device=dev),
             torch.empty((n_leaves,), dtype=torch.bool, device=dev))

    # ---- per-leaf stats: parts are groups of whole leaves, one kernel
    # launch each ---------------------------------------------------------
    leaves_per_part = max(1, part_rows // M)
    n_lparts = -(-n_leaves // leaves_per_part)
    stats_of = leaf_stats.launcher(paa, words, order_d, n, leaf_capacity=M,
                                   bits=config.bits, bound=config.bound,
                                   out=stats)

    def p_leaf_stats(i: int) -> None:
        gl = i * leaves_per_part
        stats_of(gl, min(gl + leaves_per_part, n_leaves))

    run_phase("leaf_stats", n_lparts, p_leaf_stats)

    # ---- materialize: gather rows into the padded leaf-ordered arrays,
    # one kernel launch a part ---------------------------------------------
    n_mparts = -(-n_pad // part_rows)
    gather = leaf_gather.launcher(
        order_d, (series_src, paa, words, sqn),
        (out_series, out_paa, out_words, out_sqn, out_perm), perm_src)

    def p_materialize(i: int) -> None:
        lo = i * part_rows
        hi = min(lo + part_rows, n)
        if hi > lo:                     # else pure padding rows: prefilled
            gather(lo, hi)

    run_phase("materialize", n_mparts, p_materialize)

    leaf_lo, leaf_hi, leaf_valid = stats
    return FlatIndex(series=out_series, paa=out_paa, words=out_words,
                     sq_norms=out_sqn, perm=out_perm, valid=out_perm >= 0,
                     leaf_lo=leaf_lo, leaf_hi=leaf_hi, leaf_valid=leaf_valid)


class IndexBuilder:
    """Streaming, phase-modular, lock-free index construction.

    config     IndexConfig (or None for defaults); `**overrides` are
               IndexConfig fields, mirroring `FreshIndex.build`
    workers    0/1 = sequential single-shot; N >= 2 = RefreshExecutor with
               N lock-free workers (owner/helper modes per phase)
    part_rows  rows per part, the unit of work assignment.  Part
               boundaries depend ONLY on this value, never on how feed()
               calls sliced the data, which is what makes chunked feeds
               bit-identical to one-shot builds
    injectors  refresh.Injectors for crash/delay experiments (multi-worker
               only); even with every worker crashed, finalize() completes
               because the calling thread helps (traverse_complete)
    executor   explicit traverse.Executor (overrides workers/injectors)
    device     where the index lives and the kernels run; None = "cuda"
    """

    def __init__(self, config=None, *, workers: int = 0,
                 part_rows: int = 2048,
                 injectors: Optional[Injectors] = None,
                 executor: Optional[Executor] = None, device=None,
                 **overrides):
        from repro_torch.api import IndexConfig, resolve_device
        if config is None:
            config = IndexConfig()
        if overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        if part_rows < 1:
            raise ValueError("part_rows must be >= 1")
        self.part_rows = int(part_rows)
        self.workers = int(workers)
        self.device = resolve_device(device)
        if executor is not None:
            self._executor = executor
        elif self.workers >= 2:
            self._executor = RefreshExecutor(n_threads=self.workers,
                                             injectors=injectors)
        else:
            self._executor = SequentialExecutor()

        self._L: Optional[int] = None
        self._n = 0
        self._tail: List[torch.Tensor] = []    # fed rows not yet a block
        self._tail_rows = 0
        self._raw_blocks: List[Optional[torch.Tensor]] = []
        self._offsets: List[int] = []          # global row offset per block
        # per feed batch, on the device: (f32 normalized series, paa,
        # uint8 words, sq_norms) of its blocks' rows
        self._batches: List[tuple] = []
        self._words_np: List[tuple] = []  # per block: (host words, event)
        self._keys: List[np.ndarray] = []
        self._runs: List[np.ndarray] = []      # sorted global ids per block
        self._finalized = False
        self._stats = {p: {"parts": 0, "runs": 0, "applications": 0,
                           "helped_parts": 0, "mode_switches": 0,
                           "crashed_workers": 0, "wall_time": 0.0}
                       for p in PHASES}

    # ------------------------------------------------------------------ #
    # public API
    # ------------------------------------------------------------------ #
    @property
    def n_fed(self) -> int:
        """Total rows fed so far (processed blocks + buffered tail)."""
        return self._n + self._tail_rows

    def feed(self, chunk) -> "IndexBuilder":
        """Ingest `chunk`, an (m, L) or (L,) array or tensor; returns self.
        Complete `part_rows` blocks are summarized, keyed and sorted
        EAGERLY; the remainder buffers until the next feed or finalize().

        Raises:
            ValueError: chunk is not 1/2-D or its series length
                disagrees with earlier feeds (or the config).
            RuntimeError: called after finalize().

        Concurrency: single feeder; the phase work fans out to the
        Refresh workers.  The caller may reuse its chunk after feed()
        returns (the builder copies what outlives the call).
        """
        if self._finalized:
            raise RuntimeError("feed() after finalize()")
        c = torch.as_tensor(chunk, dtype=torch.float32, device=self.device)
        if c.dim() == 1:
            c = c[None]
        if c.dim() != 2:
            raise ValueError(f"chunk must be (m, L), got shape "
                             f"{tuple(c.shape)}")
        if self._L is None:
            self.config.validate_series_len(c.shape[1])
            self._L = c.shape[1]
        elif c.shape[1] != self._L:
            raise ValueError(f"chunk has series length {c.shape[1]}, "
                             f"builder holds length {self._L}")
        if c.shape[0] == 0:
            return self
        self._tail.append(c)
        self._tail_rows += c.shape[0]
        blocks = []
        while self._tail_rows >= self.part_rows:
            blocks.append(self._take_rows(self.part_rows))
        if blocks:
            self._process_blocks(blocks)
        # whatever stays in the tail outlives this call, so the builder
        # must own it: only the last entry can alias this call's chunk
        if self._tail and (self._tail[-1].untyped_storage().data_ptr()
                           == c.untyped_storage().data_ptr()):
            self._tail[-1] = self._tail[-1].clone()
        return self

    def finalize(self):
        """Run the remaining phases and return the finished FreshIndex.

        Raises:
            RuntimeError: finalize() was already called (single-use).
            ValueError: nothing was ever fed (series length unknown).

        Concurrency: single caller; completes even if every Refresh
        worker crashed (traverse_complete).
        """
        if self._finalized:
            raise RuntimeError("finalize() already called")
        order, xn, paa, words, sqn, _ = self._sorted_run()
        flat = _finalize_from_order(
            self._cast_series(xn), paa, words, sqn, order, None, self.config,
            self._run_phase, self.part_rows)
        self._finalized = True
        from repro_torch.api import FreshIndex
        return FreshIndex(flat, self.config)

    def report(self) -> dict:
        """Per-phase build telemetry: parts, payload applications (>=
        parts under helping), helped parts, crashes, wall time."""
        return {"n_rows": self.n_fed, "part_rows": self.part_rows,
                "workers": self.workers,
                "phases": {p: dict(s) for p, s in self._stats.items()}}

    # ------------------------------------------------------------------ #
    # internals
    # ------------------------------------------------------------------ #
    def _run_phase(self, name: str, n_parts: int, payload) -> None:
        if n_parts == 0:
            return
        t0 = time.perf_counter()
        stats = traverse_complete(self._executor, n_parts, payload)
        rec = self._stats[name]
        rec["parts"] += n_parts
        rec["runs"] += 1
        # the phase's wall time on the host clock, the caller's helping
        # included, whatever the executor (kernels it launched may still
        # run on the device)
        rec["wall_time"] += time.perf_counter() - t0
        if stats is not None:
            rec["applications"] += stats.applications
            rec["helped_parts"] += stats.helped_parts
            rec["mode_switches"] += stats.mode_switches
            rec["crashed_workers"] += stats.crashed_workers

    def _sorted_run(self):
        """Flush the tail, merge the runs, and hand back the globally
        sorted view (order, xn, paa, words, sqn, keys), order mapping
        sorted position -> fed row; the device tensors in fed order.
        Consumes the per-block buffers (a builder is single-use)."""
        if self._tail_rows:
            self._process_blocks([self._take_rows(self._tail_rows)])
        cfg, dev = self.config, self.device
        if self._n == 0:
            if self._L is None:
                raise ValueError("no data fed; call feed() before "
                                 "finalize()")
            # an EMPTY build is legal once the series length is known:
            # the bootstrap build(empty) -> add() -> compact()
            lanes = -(-cfg.segments * cfg.bits // 31)
            return (np.empty(0, np.int64),
                    torch.empty((0, self._L), device=dev),
                    torch.empty((0, cfg.segments), device=dev),
                    torch.empty((0, cfg.segments), dtype=torch.uint8,
                                device=dev),
                    torch.empty((0,), device=dev),
                    np.empty((0, lanes), np.int32))
        keys = np.concatenate(self._keys)
        order = self._merge_runs(keys)
        out = (order,) + tuple(_cat([b[k] for b in self._batches])
                               for k in range(4)) + (keys,)
        for lst in (self._batches, self._words_np, self._keys, self._runs):
            lst.clear()
        return out

    def _take_rows(self, m: int) -> torch.Tensor:
        out, got = [], 0
        while got < m:
            a = self._tail[0]
            need = m - got
            if a.shape[0] <= need:
                out.append(a)
                got += a.shape[0]
                self._tail.pop(0)
            else:
                out.append(a[:need])
                self._tail[0] = a[need:]
                got = m
        self._tail_rows -= m
        return out[0] if len(out) == 1 else torch.cat(out)

    def _process_blocks(self, blocks: List[torch.Tensor]) -> None:
        """Phases summarize -> key -> sort over newly completed blocks.

        Each payload writes one block's slot: disjoint, deterministic,
        idempotent, so any Refresh schedule (helpers re-applying parts
        included) produces the same bytes."""
        start = len(self._raw_blocks)
        for b in blocks:
            self._raw_blocks.append(b)
            self._offsets.append(self._n)
            self._n += b.shape[0]
            for lst in (self._words_np, self._keys, self._runs):
                lst.append(None)
        nb = len(blocks)
        cfg, dev = self.config, self.device
        ends = np.cumsum([0] + [b.shape[0] for b in blocks]).tolist()
        m, w = ends[-1], cfg.segments
        # the batch's outputs; part i writes its rows ends[i]:ends[i + 1]
        # with one launch of the summarize kernel (the function
        # `build_index` calls, which gives a row the same bits whatever
        # rows share its launch)
        xn = torch.empty((m, self._L), device=dev)
        paa = torch.empty((m, w), device=dev)
        words = torch.empty((m, w), dtype=torch.int32, device=dev)
        sqn = torch.empty((m,), device=dev)
        outs = [tuple(t[a:b] for t in (xn, paa, words, sqn))
                for a, b in zip(ends, ends[1:])]

        def p_summarize(i: int) -> None:
            summarize_rows(self._raw_blocks[start + i], segments=w,
                           bits=cfg.bits, znorm=cfg.znorm, out=outs[i])
        self._run_phase("summarize", nb, p_summarize)
        # raw rows are dead after summarization; release them only once
        # the whole phase is done (helpers may re-apply parts within it)
        for i in range(nb):
            self._raw_blocks[start + i] = None
        # the words go to the host for the key phase: on the card one copy
        # into pinned memory that no part waits for, and an event that the
        # key phase waits on
        words = words.to(torch.uint8)
        self._batches.append((xn, paa, words, sqn))
        on_card = dev.type == "cuda"
        host = torch.empty((m, w), dtype=torch.uint8, pin_memory=on_card)
        host.copy_(words, non_blocking=on_card)
        ev = None
        if on_card:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
        host_np = host.numpy()
        for i in range(nb):
            self._words_np[start + i] = (host_np[ends[i]:ends[i + 1]], ev)

        def p_key(i: int) -> None:
            j = start + i
            h, ev = self._words_np[j]
            if ev is not None:
                ev.synchronize()
            self._keys[j] = isax.interleaved_key_np(h, cfg.bits)
        self._run_phase("key", nb, p_key)

        def p_sort(i: int) -> None:
            j = start + i
            order = isax.lexsort_keys(self._keys[j])
            self._runs[j] = (self._offsets[j] + order).astype(np.int64)
        self._run_phase("sort", nb, p_sort)

    def _merge_runs(self, keys_cat: np.ndarray) -> np.ndarray:
        """Pairwise-merge adjacent sorted runs until one remains: each
        step is a linear merge (`_merge_two_sorted`, the left run wins key
        ties), so the result is the one global stable lexsort the
        one-shot build performs, without re-sorting a run."""
        runs = list(self._runs)
        if len(runs) == 1:
            return runs[0]
        packed = isax.pack_keys_bytes(keys_cat)
        while len(runs) > 1:
            pairs = [(runs[i], runs[i + 1])
                     for i in range(0, len(runs) - 1, 2)]
            carry = [runs[-1]] if len(runs) % 2 else []
            nxt: List[Optional[np.ndarray]] = [None] * len(pairs)

            def p_merge(i: int) -> None:
                a, b = pairs[i]
                nxt[i] = _merge_two_sorted(a, b, packed[a], packed[b])
            self._run_phase("merge", len(pairs), p_merge)
            runs = nxt + carry
        return runs[0]

    def _cast_series(self, xn: torch.Tensor) -> torch.Tensor:
        return xn.to(STORAGE[self.config.dtype])


def merge_sorted_delta(core: FlatIndex, delta, config, *,
                       drop_ids=None, delta_id0: Optional[int] = None,
                       workers: int = 0, part_rows: int = 2048,
                       injectors: Optional[Injectors] = None,
                       executor: Optional[Executor] = None) -> FlatIndex:
    """Incremental compaction: stable-merge the sorted core with a sorted
    delta run, on the core's device.

    The stored core arrays are kept AS-IS: series (whatever the storage
    dtype), paa, words, sq_norms and perm of the valid prefix go into the
    merged index bit for bit, so repeated compacts never re-round
    half-precision storage and never re-normalize a stored series.  Only
    the delta is summarized (once, in float32) and cast to the storage
    dtype (once).  With float32 storage the result is bit-identical to a
    fresh build over the concatenated data.  Delta ids continue at
    `delta_id0` (default: the core's valid row count).

    `drop_ids` (iterable of series ids) is the physical half of deletion:
    those core rows leave the merge input (a filtered sorted run stays
    sorted) and those delta rows never enter the delta run, so each
    dropped id disappears exactly once.  Ids are never reused, so
    compacting a drop-free index with the same `drop_ids` is the
    identity: compact∘compact == compact.
    """
    dev = core.series.device
    delta = torch.as_tensor(delta, dtype=torch.float32, device=dev)
    if delta.dim() != 2:
        raise ValueError(f"delta must be (m, L), got shape "
                         f"{tuple(delta.shape)}")
    drops = (torch.as_tensor(sorted(set(int(i) for i in drop_ids)),
                             dtype=torch.int64, device=dev)
             if drop_ids else torch.empty(0, dtype=torch.int64, device=dev))
    if delta.shape[0] == 0 and drops.numel() == 0:
        return core

    n_base = int(core.valid.sum())
    if not bool(core.valid[:n_base].all()):
        raise ValueError("core index has non-trailing padding rows; "
                         "cannot merge incrementally")
    if delta_id0 is None:
        delta_id0 = n_base

    # ---- core run: the valid prefix minus dropped rows (a filtered
    # sorted run is still sorted) --------------------------------------
    core_perm = core.perm[:n_base]
    keep = ~torch.isin(core_perm.long(), drops)
    core_series = core.series[:n_base][keep]
    core_paa = core.paa[:n_base][keep]
    core_words = core.words[:n_base][keep]
    core_sqn = core.sq_norms[:n_base][keep]
    core_perm = core_perm[keep]
    n_core = core_perm.shape[0]

    # ---- delta rows: dropped ids never enter the run ------------------
    delta_ids = delta_id0 + torch.arange(delta.shape[0], device=dev)
    dkeep = ~torch.isin(delta_ids, drops)
    delta_kept = delta[dkeep]
    delta_ids = delta_ids[dkeep].to(torch.int32)

    b = IndexBuilder(config, workers=workers, part_rows=part_rows,
                     injectors=injectors, executor=executor, device=dev)
    if delta_kept.shape[0] == 0:
        # drops only: the filtered core is already in key order
        return _finalize_from_order(
            core_series, core_paa, core_words, core_sqn,
            np.arange(n_core, dtype=np.int64), core_perm, config,
            b._run_phase, b.part_rows)

    # ---- delta run: the builder's own summarize/key/sort/merge phases ----
    d_order, d_xn, d_paa, d_words, d_sqn, d_keys = \
        b.feed(delta_kept)._sorted_run()
    d_keys = d_keys[d_order]
    d_idx = torch.from_numpy(d_order).to(dev)
    d_series = b._cast_series(d_xn)[d_idx]

    # ---- core keys from the STORED words (exact ints) -------------------
    core_words_np = core_words.cpu().numpy()
    core_keys = np.empty((n_core, d_keys.shape[1]), np.int32)
    n_kparts = -(-n_core // b.part_rows)

    def p_core_key(i: int) -> None:
        lo = i * b.part_rows
        hi = min(lo + b.part_rows, n_core)
        core_keys[lo:hi] = isax.interleaved_key_np(core_words_np[lo:hi],
                                                   config.bits)
    b._run_phase("key", n_kparts, p_core_key)

    # ---- one stable two-run merge: each sorted delta key binary-searched
    # into the sorted core (the core wins ties: its ids precede the
    # delta's, which continue at delta_id0) -----------------------------
    out: dict = {}

    def p_merge(_: int) -> None:
        m = d_keys.shape[0]
        out["order"] = _merge_two_sorted(
            np.arange(n_core, dtype=np.int64),
            np.arange(n_core, n_core + m, dtype=np.int64),
            isax.pack_keys_bytes(core_keys), isax.pack_keys_bytes(d_keys))
    b._run_phase("merge", 1, p_merge)

    return _finalize_from_order(
        torch.cat([core_series, d_series]), torch.cat([core_paa,
                                                       d_paa[d_idx]]),
        torch.cat([core_words, d_words[d_idx]]),
        torch.cat([core_sqn, d_sqn[d_idx]]), out["order"],
        torch.cat([core_perm, delta_ids[d_idx]]), config, b._run_phase,
        b.part_rows)
