"""The FreshIndex facade of the port: build, exact k-NN search, the index
lifecycle and checkpoints, on the card unless the caller asks for the CPU.

    from repro_torch.api import FreshIndex, IndexConfig

    index = FreshIndex.build(series)                  # (n, L), on "cuda"
    dist, ids = index.search(queries, k=10)           # exact k-NN
    dist, ids = index.search(queries, k=10, mode="approx", stop_eps=0.1)

    index.calibrate(ks=(10,), targets=(0.95,))        # fit stop rules
    dist, ids = index.search(queries, k=10, mode="approx",
                             recall_target=0.95)
    index.autotune()                                  # tune round_leaves

    b = FreshIndex.builder(cfg, workers=4)            # streaming, lock-free
    for chunk in stream:                              # multi-worker build
        b.feed(chunk)
    index = b.finalize()

    index.add(batch, ttl_s=60.0)   # a delta, searchable at once
    index.update(sid, series)      # new values under the stable id sid
    index.delete(ids)              # tombstones, masked out of every search
    index.expire_ttl()             # TTLs past their deadline -> tombstones
    index.compact()                # one incremental sorted-run merge

    index.save("ckpt/")            # config, arrays, lifecycle state
    index = FreshIndex.load("ckpt/")

    index = FreshIndex.build(series, device="cpu")    # the plain versions

    with index.engine(EngineConfig(workers=2)) as eng:   # serving
        dist, ids = eng.submit(queries, k=10).result()

    from repro_torch.runtime import make_mesh
    index.shard(make_mesh((4,), ("data",), ["cuda:0"] * 4))  # 4 slots
                                   # of one card, leaves block-sharded
    dist, ids = index.search(queries, k=10, sync_every=2)

The counterpart of `repro.api.FreshIndex`.  Checkpoints use the layout
and format ("fresh-index-v1") of repro's, calibration and autotune
tables included, so either package loads what the other saved.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.analysis.hooks import observe
from repro_torch.checkpoint.store import load_arrays, save_checkpoint
from repro_torch.convert import flat_index_from_numpy
from repro_torch.core import isax
from repro_torch.core.builder import IndexBuilder, merge_sorted_delta
from repro_torch.core.index import STORAGE as _DTYPES
from repro_torch.core.index import (FlatIndex, build_index, index_stats,
                                    pad_leaves, summarize_rows)
from repro_torch.core.search import (batch_rounds, build_sharded_plan,
                                     shard_index, sharded_view_search,
                                     squeeze_k, view_search_device)
from repro_torch.kernels.autotune import (AutotuneTable, TuneConfig,
                                          device_kind, resolve_knobs)
from repro_torch.maintenance.tombstones import (core_dead_mask,
                                                delta_alive_mask, mask_core)
from repro_torch.quality.calibrate import CalibrationTable, index_fingerprint
from repro_torch.quality.stop_rules import EXACT, StopRule
from repro_torch.runtime.sharding import Mesh, Sharded, mesh_sig, place

_BOUNDS = ("prefix", "symbox", "paabox")
FORMAT = "fresh-index-v1"


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Every knob of the ported index in one frozen place.

    segments       PAA/iSAX word length w (series length must divide by it)
    bits           symbol cardinality 2^bits
    leaf_capacity  series per flat leaf
    bound          leaf lower bound: 'prefix' (paper MINDIST) | 'symbox'
                   | 'paabox' (tightest)
    znorm          z-normalize series and queries (the paper's setting)
    dtype          storage dtype of the series matrix; search math is f32
    round_leaves   leaves refined per query per refinement round (K);
                   None (default) = resolve through a fresh AutotuneTable
                   when installed, else the static default of 8
    pq_budget      cap on leaves admitted to the per-query priority queue
                   (None = the exact round budget; smaller values trade
                   exactness for less work, like max_rounds)

    Unset (None) knobs resolve per `FreshIndex.search_knobs`.
    """
    segments: int = isax.SEGMENTS
    bits: int = isax.SAX_BITS
    leaf_capacity: int = 64
    bound: str = "prefix"
    znorm: bool = True
    dtype: str = "float32"
    round_leaves: Optional[int] = None
    pq_budget: Optional[int] = None

    def __post_init__(self):
        if self.bound not in _BOUNDS:
            raise ValueError(f"bound must be one of {_BOUNDS}, "
                             f"got {self.bound!r}")
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {tuple(_DTYPES)}, "
                             f"got {self.dtype!r}")
        if self.segments < 1 or self.bits < 1 or self.bits > 8:
            raise ValueError("need segments >= 1 and 1 <= bits <= 8")
        if self.leaf_capacity < 1:
            raise ValueError("leaf_capacity must be >= 1")
        if self.round_leaves is not None and self.round_leaves < 1:
            raise ValueError("round_leaves must be >= 1 or None")
        if self.pq_budget is not None and self.pq_budget < 1:
            raise ValueError("pq_budget must be >= 1 or None")

    def validate_series_len(self, L: int) -> None:
        """Raise ValueError unless series length L divides into `segments`
        equal PAA frames."""
        if L % self.segments != 0:
            raise ValueError(
                f"series length {L} is not divisible by segments="
                f"{self.segments}; pick a divisor or pad the series")

    def to_dict(self) -> dict:
        """Plain-dict form of every field (what checkpoints persist)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "IndexConfig":
        """Rebuild a config from `to_dict()` output, or from repro's:
        unknown keys (repro's backend and kernel-structure knobs) are
        ignored."""
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def resolve_device(device=None) -> torch.device:
    """None means "cuda".  Raises RuntimeError when CUDA is asked for and
    there is none: the port never falls back to the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain versions on the CPU")
    return dev


class FreshIndex:
    """A built index and its lifecycle.  Construct via build(), builder(),
    from_arrays() or load()."""

    def __init__(self, idx: FlatIndex, config: IndexConfig):
        self._idx = idx
        self.config = config
        self._n_base = int(idx.valid.sum())
        self._delta: list = []                  # pending (m, L) f32 batches
        self._delta_cat = None                  # their concatenation
        self._delta_rows = None                 # ... as compaction stores it
        # ids are STABLE and never reused: `_next_id` only grows, delta
        # position p holds id `_delta_id0 + p`, and after a compaction
        # that drops tombstones the id space is sparse
        self._next_id = self._n_base
        self._delta_id0 = self._n_base
        self._tombstones: set = set()           # logically deleted ids
        self._ttl: dict = {}                    # id -> monotonic deadline
        self._first_tombstone_at: Optional[float] = None
        self._masked = None                     # search_view cache ...
        self._masked_key = None                 # ... keyed (ver, pending)
        self._lifecycle_ver = 0
        # update(sid, x) retires the old row and adds the new one under a
        # fresh internal id that keeps answering as sid: `_id_map` is
        # stable -> internal, `_alias` internal -> stable
        self._id_map: dict = {}
        self._alias: dict = {}
        self._calibration: Optional[CalibrationTable] = None
        self._autotune: Optional[AutotuneTable] = None
        self._fp = None                         # fingerprint cache ...
        self._fp_key = None                     # ... keyed (ver, pending)
        self._mesh = None                       # the mesh when sharded ...
        self._mesh_axis = "data"
        self._shards = None                     # ... and its leaf blocks
        self._sharded_fns: dict = {}            # resolved knobs -> plan

    # ------------------------------------------------------------------ #
    # construction
    # ------------------------------------------------------------------ #
    @classmethod
    def build(cls, data, config: Optional[IndexConfig] = None, *,
              device=None) -> "FreshIndex":
        """Bulk-build an index over `data`, an (n, L) float array or tensor.

        Args:
            data: (n, L) series, cast to float32 on `device`; n == 0 is
                the bootstrap (build empty, then add and compact).
            config: IndexConfig (None = defaults).
            device: where the index lives and the kernels run; None means
                "cuda".
        Returns:
            A new FreshIndex.
        Raises:
            ValueError: data is not 2-D, or L fails
                `config.validate_series_len`.
            RuntimeError: CUDA asked for (or defaulted to) and missing.

        One pass over all rows (`build_index`); `builder()` gives the same
        arrays bit for bit through the Refresh-driven phases, and takes
        the empty bootstrap.
        """
        cfg = config or IndexConfig()
        dev = resolve_device(device)
        x = torch.as_tensor(data, dtype=torch.float32, device=dev)
        if x.dim() != 2:
            raise ValueError(f"data must be (n, L), got shape "
                             f"{tuple(x.shape)}")
        if x.shape[0] == 0:
            return cls.builder(cfg, device=dev).feed(x).finalize()
        cfg.validate_series_len(x.shape[1])
        idx = build_index(x, segments=cfg.segments, bits=cfg.bits,
                          leaf_capacity=cfg.leaf_capacity, znorm=cfg.znorm,
                          bound=cfg.bound)
        if cfg.dtype != "float32":
            idx = idx._replace(series=idx.series.to(_DTYPES[cfg.dtype]))
        return cls(idx, cfg)

    @classmethod
    def builder(cls, config: Optional[IndexConfig] = None,
                **builder_kwargs) -> IndexBuilder:
        """An `IndexBuilder` for streaming / multi-worker construction
        (workers, part_rows, injectors, executor, device: see
        `repro_torch.core.builder.IndexBuilder`); single-use."""
        return IndexBuilder(config, **builder_kwargs)

    @classmethod
    def from_arrays(cls, arrays: dict, config: IndexConfig,
                    device=None) -> "FreshIndex":
        """Wrap a `repro` index carried across as numpy arrays (one per
        FlatIndex field, see `repro_torch.convert`); device None means
        "cuda"."""
        return cls(flat_index_from_numpy(arrays, resolve_device(device)),
                   config)

    # ------------------------------------------------------------------ #
    # introspection
    # ------------------------------------------------------------------ #
    @property
    def index(self) -> FlatIndex:
        """The underlying FlatIndex (read-only use)."""
        return self._idx

    @property
    def device(self) -> torch.device:
        """Where the index lives and its kernels run."""
        return self._idx.series.device

    @property
    def mesh(self):
        """The `runtime.sharding.Mesh` this index is sharded over; None
        when unsharded."""
        return self._mesh

    @property
    def mesh_axis(self) -> str:
        """The mesh axis the leaves are block-sharded over ('data' by
        default; meaningful only while `mesh` is not None)."""
        return self._mesh_axis

    @property
    def series_len(self) -> int:
        """Length L of every indexed series (and of valid queries)."""
        return self._idx.series.shape[1]

    @property
    def n_series(self) -> int:
        """Searchable series: the compacted core plus the pending delta,
        less the tombstoned ones (which stay physical until compact());
        what k may not exceed."""
        return self._n_base + self.n_pending - len(self._tombstones)

    @property
    def n_pending(self) -> int:
        """Rows in the uncompacted delta (tombstoned ones included)."""
        return sum(b.shape[0] for b in self._delta)

    @property
    def n_deleted(self) -> int:
        """Live tombstones: deleted, not yet dropped by compact()."""
        return len(self._tombstones)

    @property
    def n_ttl(self) -> int:
        """Series carrying a pending TTL deadline."""
        return len(self._ttl)

    def stats(self) -> dict:
        """Host-side summary: leaf count and fill, pending rows, sharded
        or not, tombstones, TTLs, aliases (the keys of repro's)."""
        st = index_stats(self._idx)
        st["n_pending"] = self.n_pending
        st["sharded"] = self._mesh is not None
        st["n_deleted"] = self.n_deleted
        st["n_ttl"] = self.n_ttl
        st["n_aliases"] = len(self._alias)
        st["calibrated"] = self._calibration is not None
        st["autotuned"] = self._autotune is not None
        return st

    def __repr__(self) -> str:
        return (f"FreshIndex(n={self.n_series}, L={self.series_len}, "
                f"pending={self.n_pending}, config={self.config})")

    # ------------------------------------------------------------------ #
    # search
    # ------------------------------------------------------------------ #
    def search(self, queries, k: int = 1, *,
               mode: str = "exact", recall_target: float = 0.95,
               stop_eps: Optional[float] = None,
               max_leaves: Optional[int] = None,
               round_leaves: Optional[int] = None,
               max_rounds: Optional[int] = None,
               pq_budget: Optional[int] = None,
               sync_every: int = 1
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """k-NN of `queries`, an (L,) or (Q, L) float array or tensor.

        Returns:
            (dist, ids) on the index's device: (Q,) for k == 1, (Q, k)
            ascending by distance otherwise.  Distances are Euclidean,
            recomputed in direct form for the winners: TRUE distances to
            the returned series in both modes.  A pending delta is
            scanned exactly (its rows as compaction will store them,
            `delta_rows`) and merged in; tombstoned series never appear
            (the search runs over `search_view`); rows renamed by
            update() answer under their stable id.
        Raises:
            ValueError: query length != series_len, k < 1 or k > n_series,
                or mode/stop-rule arguments are inconsistent (see
                `resolve_stop_rule`).

        `mode` selects the quality tier: "exact" (default, certified
        k-NN) or "approx": the refinement stops early under a
        `quality.stop_rules.StopRule`, either given explicitly
        (`stop_eps` / `max_leaves`) or resolved from this index's
        calibration table as the cheapest fitted rule whose MEASURED
        recall@k met `recall_target` (run `calibrate()` first, or load a
        calibrated checkpoint).  `max_rounds` caps the refinement rounds
        the blunt way (distances become upper bounds).  round_leaves /
        pq_budget default from this index's IndexConfig, with UNSET
        config knobs resolved through a fresh autotune table when one is
        installed (see `search_knobs`); explicit values override per
        call.  On a sharded index `sync_every` is the number of rounds
        between two publications of the global k-th bound (the
        expeditive/standard cadence) and keys the per-mesh plan cache;
        unsharded searches ignore it.

        Concurrency: a reader; serialize against writers.
        """
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        if q.dim() == 1:
            q = q[None]
        if q.shape[-1] != self.series_len:
            raise ValueError(
                f"queries have length {q.shape[-1]}, index holds series of "
                f"length {self.series_len}")
        if not 1 <= k <= self.n_series:
            raise ValueError(f"k must be in [1, {self.n_series}], got {k}")
        rule = self.resolve_stop_rule(mode, k=k, recall_target=recall_target,
                                      stop_eps=stop_eps,
                                      max_leaves=max_leaves)
        kn = self.search_knobs()
        knobs = dict(
            max_rounds=max_rounds,
            round_leaves=(round_leaves if round_leaves is not None
                          else kn.round_leaves),
            pq_budget=pq_budget if pq_budget is not None else kn.pq_budget,
            **rule.lower())
        if self._mesh is not None:
            _, delta, alive, id0 = self.search_view()
            d, i, _ = sharded_view_search(
                self.sharded_plan(k, sync_every=sync_every, **knobs),
                self.shard_view(), None if delta is None
                else self.delta_rows, alive, id0, q, znorm=self.config.znorm)
        else:
            d, i, _ = self._plan(q, k, **knobs)
        d, i = squeeze_k(d, i, k)
        return d, self._remap_ids(i)

    def _plan(self, q: torch.Tensor, k: int, *, round_leaves: int,
              pq_budget: Optional[int] = None,
              max_rounds: Optional[int] = None, stop_eps: float = 0.0,
              stop_leaves: Optional[int] = None):
        """The plan a local `search` runs, with every knob resolved:
        (dist, ids, rounds), (Q, k) internal ids before `_remap_ids`.
        `view_search_device` over `search_view()`, a pending delta as its
        rows as compaction will store them (`delta_rows`); the serving
        engine's plans run the same function.  The calibrator and the
        autotune sweep run this too, so they measure what search runs; on
        a sharded index they measure the local plan over the whole
        index, as repro's do."""
        core, delta, alive, id0 = self.search_view()
        d, i, rounds = view_search_device(
            core, None if delta is None else self.delta_rows, alive, id0, q,
            k=k, znorm=self.config.znorm, round_leaves=round_leaves,
            max_rounds=max_rounds, pq_budget=pq_budget, stop_eps=stop_eps,
            stop_leaves=stop_leaves)
        return d, i, batch_rounds(rounds)

    def sharded_plan(self, k: int, *, round_leaves: int, sync_every: int,
                     max_rounds: Optional[int] = None,
                     pq_budget: Optional[int] = None, stop_eps: float = 0.0,
                     stop_leaves: Optional[int] = None):
        """The `core.search.ShardedPlan` a sharded search with these
        resolved knobs runs, made once per (knobs, mesh placement): the
        placement is part of the key (`mesh_sig`), so a plan is never
        run on a mesh other than its own."""
        key = (k, round_leaves, sync_every, max_rounds, pq_budget, stop_eps,
               stop_leaves, self._mesh_axis, mesh_sig(self._mesh))
        plan = self._sharded_fns.get(key)
        if plan is None:
            plan = build_sharded_plan(
                self._mesh, axis=self._mesh_axis, k=k,
                round_leaves=round_leaves, sync_every=sync_every,
                max_rounds=max_rounds, znorm=self.config.znorm,
                pq_budget=pq_budget, stop_eps=stop_eps,
                stop_leaves=stop_leaves)
            self._sharded_fns[key] = plan
        return plan

    def resolve_stop_rule(self, mode: str, *, k: int,
                          recall_target: float = 0.95,
                          stop_eps: Optional[float] = None,
                          max_leaves: Optional[int] = None) -> StopRule:
        """The `StopRule` a (mode, k, recall_target) request lowers to:
        the one resolution path search() takes.

        Args:
            mode: "exact" or "approx".
            k: result count the rule will serve (calibration entries are
                per-k).
            recall_target: measured recall@k floor used for the
                calibration-table lookup (ignored when explicit knobs
                are given).
            stop_eps: explicit BSF-convergence slack; with "approx",
                overrides the table.
            max_leaves: explicit visited-leaf cap; with "approx",
                overrides the table.
        Returns:
            The resolved StopRule (`stop_rules.EXACT` for exact mode).
        Raises:
            ValueError: unknown mode; explicit knobs passed with
                mode="exact"; or mode="approx" with no explicit knobs
                and no calibration entry for (k, recall_target).

        Concurrency: read-only on calibration state; serialize against
        `calibrate()` like any reader against a writer.
        """
        if mode not in ("exact", "approx"):
            raise ValueError(f"mode must be 'exact' or 'approx', "
                             f"got {mode!r}")
        if mode == "exact":
            if stop_eps is not None or max_leaves is not None:
                raise ValueError(
                    "stop_eps/max_leaves are approx-mode knobs; they "
                    "contradict mode='exact'")
            return EXACT
        if stop_eps is not None or max_leaves is not None:
            return StopRule(eps=stop_eps if stop_eps is not None else 0.0,
                            max_leaves=max_leaves)
        if self._calibration is None:
            raise ValueError(
                "mode='approx' needs either explicit stop_eps/max_leaves "
                "or a fitted calibration table — run index.calibrate() "
                "(or load a calibrated checkpoint)")
        entry = self._calibration.lookup(k, recall_target)
        if entry is None:
            raise ValueError(
                f"no calibration entry for (k={k}, recall_target="
                f"{recall_target}); re-run calibrate() with ks/targets "
                f"covering it, or pass explicit stop_eps/max_leaves")
        return entry.rule

    def calibrate(self, **kwargs) -> CalibrationTable:
        """Fit approximate-search stop rules for this index and install
        the resulting table (see `repro_torch.quality.calibrate.calibrate`
        for every argument: ks, targets, queries/n_queries, eps_grid,
        leaves_grid, ...).  The installed table is what
        `search(mode="approx")` resolves rules from, and `save()`
        persists it with the checkpoint.

        Args:
            **kwargs: forwarded verbatim to the offline calibrator.
        Returns:
            The fitted CalibrationTable (also stored on the index).

        Concurrency: a writer of calibration state (and a reader of the
        index); serialize against other writers like add().
        """
        from repro_torch.quality.calibrate import calibrate as _fit
        table = _fit(self, **kwargs)
        self._calibration = table
        return table

    @property
    def calibration(self) -> Optional[CalibrationTable]:
        """The installed CalibrationTable (None until calibrate() runs
        or a calibrated checkpoint is loaded)."""
        return self._calibration

    def is_calibration_fresh(self) -> bool:
        """True when the installed calibration table was measured on
        EXACTLY this index content (fingerprints match), i.e. its
        advertised recalls still describe what approx search returns.
        Mutations (add/delete/update/compact) make it stale; stale
        tables still resolve (documented degradation).  A table repro
        fitted is stale here: the fingerprint hashes each package's own
        config.

        Concurrency: a reader; the fingerprint is cached per lifecycle
        version, so repeated calls are cheap.
        """
        if self._calibration is None:
            return False
        return self._fingerprint() == self._calibration.fingerprint

    def _fingerprint(self) -> str:
        """The content fingerprint, cached per lifecycle version (shared
        by the calibration and autotune freshness checks)."""
        key = (self._lifecycle_ver, self.n_pending)
        if self._fp_key != key:
            self._fp = index_fingerprint(self)
            self._fp_key = key
        return self._fp

    # ------------------------------------------------------------------ #
    # search-knob autotune (repro_torch.kernels.autotune)
    # ------------------------------------------------------------------ #
    def autotune(self, **kwargs) -> AutotuneTable:
        """Sweep search-knob candidates on this index's device and
        install the winning AutotuneTable (see
        `repro_torch.kernels.autotune.autotune_index` for every argument:
        queries, n_queries, k, repeat, quick, candidates, seed).  Every
        candidate is gated on BITWISE equality with the default-knob
        search output before it may win, so installing the table never
        changes any search result, only its latency.  The installed
        table is what `search_knobs` resolves unset IndexConfig knobs
        through, and `save()` persists it with the checkpoint.

        Args:
            **kwargs: forwarded verbatim to the sweep harness.
        Returns:
            The measured AutotuneTable (also stored on the index).

        Concurrency: a writer of autotune state (and a reader of the
        index); serialize against writers like calibrate().
        """
        from repro_torch.kernels.autotune import autotune_index
        table = autotune_index(self, **kwargs)
        self._autotune = table
        return table

    @property
    def autotune_table(self) -> Optional[AutotuneTable]:
        """The installed AutotuneTable (None until autotune() runs or a
        tuned checkpoint is loaded)."""
        return self._autotune

    def is_autotune_fresh(self) -> bool:
        """True when the installed autotune table was measured on
        EXACTLY this index content (fingerprints match).  Mutations
        (add/delete/update/compact) make it stale; a stale table is NOT
        resolved through: `search_knobs` falls back to the static
        defaults until a re-tune.

        Concurrency: a reader; the fingerprint is cached per lifecycle
        version, so repeated calls are cheap.
        """
        if self._autotune is None:
            return False
        return self._fingerprint() == self._autotune.fingerprint

    def search_knobs(self) -> TuneConfig:
        """The fully-resolved search knobs this index serves with, as a
        `kernels.autotune.TuneConfig`: each knob is the IndexConfig
        field when set, else the FRESH autotune-table entry for this
        (device_kind, L, leaf_capacity, dtype) when one is installed,
        else the static default (`kernels.autotune.DEFAULTS`), so an
        untuned index, an unknown device, or a stale table all behave
        exactly as before autotune.  The one resolution path search()
        and the calibrator share.

        Concurrency: a reader (of config + autotune state).
        """
        entry = None
        if self._autotune is not None and self.is_autotune_fresh():
            entry = self._autotune.lookup(
                device_kind(self.device), self.series_len,
                self.config.leaf_capacity, self.config.dtype)
        return resolve_knobs(self.config, entry)

    def _remap_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """Internal -> stable ids at the result boundary (rows renamed by
        update()); untouched until the first update()."""
        if not self._alias:
            return ids
        out = ids.clone()
        internal = torch.as_tensor(list(self._alias), dtype=ids.dtype,
                                   device=ids.device)
        stable = torch.as_tensor(list(self._alias.values()), dtype=ids.dtype,
                                 device=ids.device)
        hit = ids[..., None] == internal
        found = hit.any(-1)
        out[found] = stable[hit.to(torch.int8).argmax(-1)][found]
        return out

    def search_view(self):
        """The tombstone-masked search inputs `(core, delta, delta_alive,
        delta_id0)`: the core with its dead rows' norms at the never-wins
        sentinel (the stored arrays untouched), the pending delta as one
        (m, L) tensor (None when empty), its (m,) alive mask (None when all
        alive), and the delta's id offset.  Cached until the next
        lifecycle change."""
        key = (self._lifecycle_ver, self.n_pending)
        if self._masked_key != key:
            if self._tombstones:
                core = mask_core(self._idx, core_dead_mask(
                    self._idx.perm, self._tombstones))
                alive = delta_alive_mask(self.n_pending, self._delta_id0,
                                         self._tombstones, self.device)
            else:
                core, alive = self._idx, None
            shards = self._shards
            if shards is not None and core is not self._idx:
                # the dead rows' sentinel norms, inside each shard
                norms = place(core.sq_norms,
                              Sharded(self._mesh, self._mesh_axis))
                shards = tuple(sh._replace(sq_norms=n)
                               for sh, n in zip(shards, norms))
            self._masked = (core, alive, shards)
            self._masked_key = key
        core, alive, _ = self._masked
        return core, self.delta_cat, alive, self._delta_id0

    def shard_view(self):
        """The masked core of `search_view()` as the mesh's leaf blocks
        (`core.search.shard_index` of it): a tuple of FlatIndex, block s
        on slot s, or None when the index is not sharded."""
        self.search_view()
        return self._masked[2]

    @property
    def delta_cat(self) -> Optional[torch.Tensor]:
        """The pending delta as one (m, L) tensor on the index's device
        (None when empty), cached between add() calls."""
        if not self._delta:
            return None
        if self._delta_cat is None:
            observe("index.delta_cat", self)
            self._delta_cat = torch.cat(self._delta)
        return self._delta_cat

    @property
    def delta_rows(self) -> Optional[torch.Tensor]:
        """The pending delta as compaction will store it: float32 rows,
        z-normalized by the summarize kernel when config.znorm (None when
        empty), cached with `delta_cat`.  The delta scan reads these, so
        a row has the same bits, hence the same distances, before and
        after compaction."""
        if not self._delta:
            return None
        if self._delta_rows is None:
            cfg = self.config
            self._delta_rows = summarize_rows(
                self.delta_cat, segments=cfg.segments, bits=cfg.bits,
                znorm=cfg.znorm)[0]
        return self._delta_rows

    # ------------------------------------------------------------------ #
    # serving
    # ------------------------------------------------------------------ #
    def engine(self, config=None, **overrides):
        """A serving-layer QueryEngine over this index
        (`repro_torch.serve`): micro-batched `submit(q, k=...)`
        futures, one captured CUDA graph per (bucket, k, knobs, epoch)
        on the card (steady state replays and never captures), and
        snapshot-consistent concurrent add / update / delete / compact.
        A sharded index gets eager sharded plans, mesh-wide epochs and
        `recover(checkpoint, mesh=...)`.

        Args:
            config: EngineConfig (None = defaults).
            **overrides: EngineConfig fields, mirroring build().
        Returns:
            A started QueryEngine bound to this index.
        Raises:
            ValueError: `donate=True` on a CPU index.

        Concurrency: the engine serializes all writers to this index
        through its own locks; do not mutate the index out-of-band
        while an engine serves it (or call `engine.refresh()` after).
        """
        from repro_torch.serve import EngineConfig, QueryEngine
        cfg = config or EngineConfig()
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        return QueryEngine(self, cfg)

    # ------------------------------------------------------------------ #
    # updates (Jiffy-style batch delta)
    # ------------------------------------------------------------------ #
    def add(self, batch, *, ttl_s: Optional[float] = None) -> "FreshIndex":
        """Append `batch` ((L,) or (m, L)) to the delta: no rebuild, and
        searchable at once by an exact scan.  Ids continue from the
        monotone id counter.  `ttl_s` gives every row of this batch a
        time to live: past it, the next expire_ttl() tombstones them.

        Raises:
            ValueError: batch is not (m, series_len), or ttl_s <= 0.

        Concurrency: a writer.
        """
        if ttl_s is not None and ttl_s <= 0:
            raise ValueError(f"ttl_s must be > 0 or None, got {ttl_s}")
        # a copy the delta owns: a caller reusing its buffer must not
        # rewrite pending rows
        b = torch.tensor(np.asarray(batch, np.float32)) \
            if not isinstance(batch, torch.Tensor) \
            else batch.detach().to(torch.float32).clone()
        b = b.to(self.device)
        if b.dim() == 1:
            b = b[None]
        if b.dim() != 2 or b.shape[1] != self.series_len:
            raise ValueError(f"batch must be (m, {self.series_len}), got "
                             f"{tuple(b.shape)}")
        first_id = self._delta_id0 + self.n_pending
        self._delta.append(b)
        self._delta_cat = self._delta_rows = None
        self._next_id += b.shape[0]
        if ttl_s is not None:
            deadline = time.monotonic() + ttl_s
            for sid in range(first_id, first_id + b.shape[0]):
                self._ttl[sid] = deadline
        return self

    def update(self, sid: int, series, *,
               ttl_s: Optional[float] = None) -> "FreshIndex":
        """Replace series `sid`'s values under its STABLE id: the old row
        is tombstoned and the new one added under a fresh internal id that
        search reports as `sid` (the alias survives compaction and
        checkpoints).

        Raises:
            ValueError: `sid` is not a live series, or `series` is not
                (L,).

        Concurrency: a writer; the retire and add are not atomic against
        concurrent readers.
        """
        sid = int(sid)
        cur = self._id_map.get(sid, sid)
        row = torch.as_tensor(np.asarray(series, np.float32)) \
            if not isinstance(series, torch.Tensor) else series.float()
        if row.dim() != 1 or row.shape[0] != self.series_len:
            raise ValueError(f"series must be ({self.series_len},), got "
                             f"{tuple(row.shape)}")
        if self.delete(cur) == 0:
            raise ValueError(
                f"id {sid} is not a live series; update() replaces an "
                f"existing row (use add() for new series)")
        internal = self._delta_id0 + self.n_pending
        self.add(row, ttl_s=ttl_s)
        self._id_map[sid] = internal
        self._alias[internal] = sid
        return self

    # ------------------------------------------------------------------ #
    # deletion and TTL expiry
    # ------------------------------------------------------------------ #
    def delete(self, ids: Union[int, Iterable[int]]) -> int:
        """Logically delete series by id: they stop matching any search at
        once and are dropped, exactly once, by the next compact().
        Already deleted or dropped ids are skipped.  Returns the number of
        series newly tombstoned.

        Raises:
            ValueError: an id is negative or was never assigned.

        Concurrency: a writer.
        """
        if isinstance(ids, (int, np.integer)):
            ids = (int(ids),)
        elif isinstance(ids, (torch.Tensor, np.ndarray)):
            ids = ids.tolist()
        # a stable id renamed by update() resolves to its current row
        ids = [self._id_map.get(int(i), int(i)) for i in ids]
        for sid in ids:
            if sid < 0 or sid >= self._next_id:
                raise ValueError(
                    f"id {sid} was never assigned (ids run 0.."
                    f"{self._next_id - 1})")
        d_lo, d_hi = self._delta_id0, self._delta_id0 + self.n_pending
        # which core ids are still stored, asked once on the device
        core = [i for i in ids if not d_lo <= i < d_hi]
        stored = set()
        if core:
            c = torch.as_tensor(core, dtype=torch.int64, device=self.device)
            hit = torch.isin(c, self._idx.perm[self._idx.valid].long())
            stored = set(c[hit].tolist())
        newly = 0
        for sid in ids:
            if sid in self._tombstones:
                continue
            if not d_lo <= sid < d_hi and sid not in stored:
                continue                    # already dropped by a compact
            self._tombstones.add(sid)
            self._ttl.pop(sid, None)
            stable = self._alias.pop(sid, None)
            if stable is not None:
                self._id_map.pop(stable, None)
            newly += 1
        if newly:
            if self._first_tombstone_at is None:
                self._first_tombstone_at = time.monotonic()
            self._lifecycle_ver += 1
        return newly

    def expire_ttl(self, now: Optional[float] = None) -> int:
        """Tombstone every series whose TTL deadline has passed.  `now` is
        a `time.monotonic()` value (None = the current time; tests pass a
        clock).  Returns the number expired.  Concurrency: a writer."""
        if now is None:
            now = time.monotonic()
        expired = [sid for sid, dl in self._ttl.items() if dl <= now]
        return self.delete(expired) if expired else 0

    @property
    def tombstone_age_s(self) -> float:
        """Seconds since the oldest live tombstone was made (0.0 if none)."""
        if self._first_tombstone_at is None:
            return 0.0
        return time.monotonic() - self._first_tombstone_at

    # ------------------------------------------------------------------ #
    # compaction
    # ------------------------------------------------------------------ #
    def compact(self) -> "FreshIndex":
        """Merge the delta into the core and drop the tombstoned rows, with
        one incremental sorted-run merge (`merge_sorted_delta`): stored
        rows keep their bits, only the delta is summarized and cast, once.
        With float32 storage the result is bit-identical to a fresh build
        over the live rows; compact∘compact == compact.

        Concurrency: a writer (prepare + commit back to back).
        """
        return self.commit_compact(self.prepare_compact())

    def prepare_compact(self):
        """The compacted core, computed WITHOUT changing this index: an
        opaque token for commit_compact(), or None when there is nothing
        to merge and nothing to drop."""
        drops = frozenset(self._tombstones)
        if not self._delta and not drops:
            return None
        delta = (self.delta_cat if self._delta else
                 torch.zeros((0, self.series_len), device=self.device))
        merged = merge_sorted_delta(self._idx, delta, self.config,
                                    drop_ids=drops or None,
                                    delta_id0=self._delta_id0)
        shards = None
        if self._mesh is not None:
            # pad and cut the merged core HERE, in the heavy phase, so the
            # commit stays a pointer swap under a serving lock
            merged = pad_leaves(merged, self._mesh.shape[self._mesh_axis])
            shards = shard_index(merged, self._mesh, self._mesh_axis)
        return (merged, shards, delta.shape[0], len(self._delta), drops)

    def commit_compact(self, token) -> "FreshIndex":
        """Install a prepare_compact() token: the merged core, an empty
        delta and tombstone set, and the delta id offset at the high-water
        mark (dropped ids stay retired).

        Raises:
            RuntimeError: the delta or the tombstones changed since the
                token was prepared (a raced add or delete).
        """
        if token is None:
            return self
        merged, shards, n_rows, n_batches, drops = token
        if (len(self._delta) != n_batches
                or sum(b.shape[0] for b in self._delta) != n_rows):
            raise RuntimeError(
                "delta changed between prepare_compact and commit_compact; "
                "serialize writers around the prepare/commit pair")
        if frozenset(self._tombstones) != drops:
            raise RuntimeError(
                "tombstones changed between prepare_compact and "
                "commit_compact; serialize writers around the "
                "prepare/commit pair")
        if (shards is None) != (self._mesh is None):
            raise RuntimeError(
                "the index was sharded or unsharded between "
                "prepare_compact and commit_compact")
        self._idx = merged
        self._shards = shards
        self._n_base = int(merged.valid.sum())
        self._delta = []
        self._delta_cat = self._delta_rows = None
        self._tombstones = set()
        self._first_tombstone_at = None
        self._delta_id0 = self._next_id
        self._masked = None
        self._masked_key = None
        self._lifecycle_ver += 1
        return self

    # ------------------------------------------------------------------ #
    # sharding
    # ------------------------------------------------------------------ #
    def shard(self, mesh, axis: str = "data") -> "FreshIndex":
        """Block-shard the leaves (and their rows) over the `axis` axis of
        `mesh` (a `runtime.sharding.Mesh`), padding to a whole number of
        leaves per shard (`pad_leaves`), and route later search() calls
        through the sharded expeditive/standard plan.  The index (and any
        pending delta) moves to the axis' first slot; each shard is a
        view of it where its slot is that device, a copy on its slot
        otherwise.  Returns self.

        Raises:
            TypeError: `mesh` is not a Mesh.
            ValueError: `axis` is not an axis of `mesh`.

        Concurrency: a writer (replaces the placed arrays and drops the
        plan cache); serialize like add/compact.  A serving engine
        re-places through recover(), never this method directly.
        """
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a runtime.sharding.Mesh, got "
                            f"{type(mesh).__name__}")
        home = mesh.axis_devices(axis)[0]
        idx = pad_leaves(self._idx, mesh.shape[axis])
        if idx.series.device != home:
            idx = FlatIndex(*(t.to(home) for t in idx))
            self._delta = [b.to(home) for b in self._delta]
            self._delta_cat = self._delta_rows = None
        self._idx = idx
        self._shards = shard_index(idx, mesh, axis)
        self._mesh = mesh
        self._mesh_axis = axis
        self._sharded_fns = {}
        # the masked search view wraps the old placement
        self._masked = None
        self._masked_key = None
        self._lifecycle_ver += 1
        return self

    # ------------------------------------------------------------------ #
    # checkpoints
    # ------------------------------------------------------------------ #
    def save(self, directory: str, step: int = 0) -> str:
        """Persist the config, the index arrays, any pending delta, the
        lifecycle state (ids, tombstones, TTLs as remaining seconds,
        aliases) and the installed calibration and autotune tables into
        `directory` at `step`; returns the checkpoint path.  Restore with
        load() or reload(), no rebuild.  A sharded index saves its whole
        (padded) arrays, so the checkpoint restores onto any mesh."""
        delta = (self.delta_cat if self._delta else
                 torch.zeros((0, self.series_len)))
        tree = {"index": self._idx._asdict(), "delta": delta}
        now = time.monotonic()
        extra = {"config": self.config.to_dict(),
                 "n_series": self._n_base,
                 "format": FORMAT,
                 "lifecycle": {
                     "next_id": self._next_id,
                     "delta_id0": self._delta_id0,
                     "tombstones": sorted(self._tombstones),
                     "ttl": [[int(sid), max(0.0, dl - now)]
                             for sid, dl in sorted(self._ttl.items())],
                     "aliases": [[int(i), int(s)]
                                 for i, s in sorted(self._alias.items())],
                 }}
        if self._calibration is not None:
            extra["quality_calibration"] = self._calibration.to_dict()
        if self._autotune is not None:
            extra["autotune"] = self._autotune.to_dict()
        return save_checkpoint(directory, step, tree, extra=extra)

    @classmethod
    def load(cls, directory: str, step: Optional[int] = None, *,
             device=None) -> "FreshIndex":
        """Restore a save()d index (this package's or repro's) from
        `directory` at `step` (None = latest) onto `device` (None means
        "cuda"): config, arrays, delta, lifecycle and the calibration and
        autotune tables, no rebuild.  The restored index is unsharded;
        call shard(mesh) to place it.

        Raises:
            ValueError: not a FreshIndex checkpoint, or the manifest's
                series count disagrees with the arrays.
        """
        dev = resolve_device(device)
        arrays, manifest = load_arrays(directory, step=step)
        extra = manifest.get("extra", {})
        if extra.get("format") != FORMAT:
            raise ValueError(
                f"{directory} is not a FreshIndex checkpoint "
                f"(format={extra.get('format')!r})")
        cfg = IndexConfig.from_dict(extra["config"])
        idx = FlatIndex(**{f: arrays[f"index/{f}"].to(dev)
                           for f in FlatIndex._fields})
        out = cls(idx, cfg)
        saved_n = extra.get("n_series")
        if saved_n is not None and saved_n != out._n_base:
            raise ValueError(
                f"corrupt checkpoint: manifest records {saved_n} series "
                f"but the index arrays hold {out._n_base}")
        delta = arrays.get("delta")
        if delta is not None and delta.shape[0]:
            out._delta = [delta.float().to(dev)]
        life = extra.get("lifecycle")
        if life is not None:
            now = time.monotonic()
            out._next_id = int(life["next_id"])
            out._delta_id0 = int(life["delta_id0"])
            out._tombstones = {int(t) for t in life["tombstones"]}
            out._ttl = {int(s): now + float(r) for s, r in life["ttl"]}
            out._alias = {int(i): int(s)
                          for i, s in life.get("aliases", ())}
            out._id_map = {s: i for i, s in out._alias.items()}
            if out._tombstones:
                out._first_tombstone_at = now
        else:
            # a checkpoint from before the lifecycle: ids were contiguous
            out._next_id = out._n_base + out.n_pending
            out._delta_id0 = out._n_base
        calib = extra.get("quality_calibration")
        if calib is not None:
            out._calibration = CalibrationTable.from_dict(calib)
        tuned = extra.get("autotune")
        if tuned is not None:
            out._autotune = AutotuneTable.from_dict(tuned)
        return out

    def reload(self, directory: str, step: Optional[int] = None
               ) -> "FreshIndex":
        """Swap THIS object's state for a save()d checkpoint, in place, on
        this index's device: exactly `FreshIndex.load(directory, step)`,
        unsharded (a serving engine's recover() re-shards it).

        Raises:
            ValueError: not a FreshIndex checkpoint, or its IndexConfig
                differs from this index's.
        """
        loaded = FreshIndex.load(directory, step=step, device=self.device)
        if loaded.config != self.config:
            raise ValueError(
                f"checkpoint config {loaded.config} does not match this "
                f"index's {self.config}; refusing to reload across "
                f"configs")
        self.__dict__.update(loaded.__dict__)
        return self
