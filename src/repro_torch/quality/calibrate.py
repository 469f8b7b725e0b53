"""Offline calibration of approximate-search stop rules.

`calibrate(index, ...)` sweeps a grid of `StopRule(eps, max_leaves)`
settings against the tombstone-masked brute-force oracle on a held-out
query sample and, for every (k, recall_target) pair, fits the
smallest-cost setting whose MEASURED recall@k meets the target.  The
result is a `CalibrationTable` keyed by (index fingerprint, k, target)
that `FreshIndex.search(q, k, mode="approx", recall_target=...)` resolves
per call and `FreshIndex.save` persists in the manifest's
`extra["quality_calibration"]`, in repro's format, so either package
loads the other's table.

Cost ordering: among settings that meet the target, the fitter prefers
the fewest mean visited leaves (the device-independent cost), tie-broken
by measured latency.  When NO setting meets the target the exact rule is
stored with `met=False`, so an impossible target degrades to exact search
instead of silently under-delivering recall.

The counterpart of `repro.quality.calibrate`.  The oracle is numpy on
the host, independent of the plan under test, and streams the core in
row blocks, so it reads a collection on the card without a host copy of
the whole of it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.search import leaf_lower_bounds, prepare_queries

from .stop_rules import EXACT, StopRule

__all__ = ["CalibrationEntry", "CalibrationTable", "calibrate",
           "holdout_queries", "index_fingerprint", "oracle_topk",
           "pq_leaf_candidates", "recall_at_k"]

_BIG = 1e30          # matches kernels.ref.BIG / maintenance DEAD_NORM
_ORACLE_ROWS = 1 << 20   # core rows the oracle brings to the host at once
_SCAN_ROWS = 1 << 14     # rows a matmul of the oracle takes (16 MiB at L
                         # 256: its temporaries reuse the heap's memory)


def _host(x) -> np.ndarray:
    """A float32 numpy copy of an array or tensor (on any device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _remap(index, ids: np.ndarray) -> np.ndarray:
    """`index._remap_ids` on host int32 ids."""
    return index._remap_ids(torch.from_numpy(ids)).numpy()


def _live_core(core) -> torch.Tensor:
    """(n,) bool on the core's device: valid rows not masked dead."""
    return core.valid & (core.sq_norms < _BIG / 2)


# --------------------------------------------------------------------- #
# fingerprint: which index content a table's measured recall refers to
# --------------------------------------------------------------------- #
def index_fingerprint(index) -> str:
    """Stable hex digest of the SEARCHED content of `index`: config,
    core entry norms (which encode membership AND core tombstones),
    pending delta bytes, delta tombstones, and the id high-water mark.
    Two indexes with equal fingerprints answer every query identically,
    so a calibration table measured on one advertises honestly on the
    other.  The config hashed is the port's own, so a table that repro
    fitted is stale here (and the other way round)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(repr(sorted(index.config.to_dict().items())).encode())
    core = index.index
    h.update(core.sq_norms.float().cpu().numpy().tobytes())
    h.update(core.perm.to(torch.int32).cpu().numpy().tobytes())
    for b in index._delta:
        h.update(np.ascontiguousarray(_host(b)).tobytes())
    h.update(repr(sorted(index._tombstones)).encode())
    h.update(str(index._next_id).encode())
    return h.hexdigest()


# --------------------------------------------------------------------- #
# oracle: tombstone-masked brute force over the live search view
# --------------------------------------------------------------------- #
def _znorm_np(x: np.ndarray) -> np.ndarray:
    mu = x.mean(axis=-1, keepdims=True)
    sd = x.std(axis=-1, keepdims=True)
    return np.where(sd > 1e-8, (x - mu) / np.where(sd > 1e-8, sd, 1.0), 0.0)


def _oracle_blocks(index, block_rows: int):
    """The live rows of `index`'s search view, in repro's order (the
    core's stored rows in row order, then the raw pending delta
    normalized as the config says), as (rows f32, ids int32) blocks of
    at most `block_rows` core rows.  A core block is a view of one host
    buffer (pinned when the core is on the card), valid until the next
    block is drawn."""
    core, delta, alive, id0 = index.search_view()
    live = _live_core(core).cpu().numpy()
    ids = core.perm.to(torch.int32).cpu().numpy()
    n, L = core.series.shape
    buf = torch.empty((min(block_rows, n), L), dtype=torch.float32,
                      pin_memory=core.series.is_cuda)
    for s in range(0, n, block_rows):
        x = buf[:min(block_rows, n - s)]
        x.copy_(core.series[s:s + x.shape[0]])
        lv = live[s:s + x.shape[0]]
        X = x.numpy()
        yield ((X, ids[s:s + x.shape[0]]) if lv.all()
               else (X[lv], ids[s:s + x.shape[0]][lv]))
    if delta is not None:
        dx = _host(delta)
        dxn = (_znorm_np(dx).astype(np.float32) if index.config.znorm
               else dx)
        da = (np.ones(dx.shape[0], bool) if alive is None
              else alive.cpu().numpy().astype(bool))
        yield dxn[da], (id0 + np.arange(dx.shape[0], dtype=np.int32))[da]


def oracle_topk(index, queries, k: int, *, block_rows: int = _ORACLE_ROWS
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(Q, k) ground truth over `index`'s CURRENT search view: exact scan
    of the core arrays (already normalized at build time; dead rows carry
    the sentinel norm and never win) plus the raw pending delta, with
    stable ids (update() aliases applied).  Distances are direct form +
    sqrt, as `FreshIndex.search` reports them, up to summation order.

    Host-side numpy on purpose: the oracle shares no code with the plan
    under test.  The core comes to the host `block_rows` rows at a time
    and is scanned `_SCAN_ROWS` rows at a time, each part's matmul-form
    candidates merged into a running (Q, k) set, so host memory stays
    bounded at any collection size; a collection of one part (and the
    delta) is repro's scan exactly.
    """
    znorm = index.config.znorm
    q = _host(queries)
    if q.ndim == 1:
        q = q[None]
    qn = _znorm_np(q).astype(np.float32) if znorm else q
    q_sq = np.sum(qn * qn, -1)[:, None]
    Q, L = qn.shape
    cand_d2 = np.zeros((Q, 0), np.float32)   # the running candidates
    cand_x = np.zeros((Q, 0, L), np.float32)
    cand_i = np.zeros((Q, 0), np.int32)
    sq = np.empty((_SCAN_ROWS, L), np.float32)   # X * X, reused
    for Xb, Ib in _oracle_blocks(index, block_rows):
        for a in range(0, Xb.shape[0], _SCAN_ROWS):
            X, I = Xb[a:a + _SCAN_ROWS], Ib[a:a + _SCAN_ROWS]
            x_sq = np.multiply(X, X, out=sq[:X.shape[0]]).sum(-1)
            d2 = q_sq + x_sq[None, :] - 2.0 * qn @ X.T
            np.maximum(d2, 0.0, out=d2)
            kb = min(k, X.shape[0])
            part = np.argpartition(d2, kb - 1, axis=1)[:, :kb]
            cand_d2 = np.concatenate(
                [cand_d2, np.take_along_axis(d2, part, axis=1)], axis=1)
            cand_x = np.concatenate([cand_x, X[part]], axis=1)
            cand_i = np.concatenate([cand_i, I[part]], axis=1)
            if cand_d2.shape[1] > k:         # keep the running best k
                keep = np.argpartition(cand_d2, k - 1, axis=1)[:, :k]
                cand_d2 = np.take_along_axis(cand_d2, keep, axis=1)
                cand_x = np.take_along_axis(cand_x, keep[..., None], axis=1)
                cand_i = np.take_along_axis(cand_i, keep, axis=1)
    kk = cand_d2.shape[1]
    # recompute winners in direct form (the facade's reported metric)
    dd = np.sum(np.square(qn[:, None, :] - cand_x), axis=-1)
    order = np.argsort(dd, axis=1, kind="stable")
    d = np.sqrt(np.take_along_axis(dd, order, axis=1))
    i = np.take_along_axis(cand_i, order, axis=1)
    if kk < k:                                        # pad like the plans
        d = np.pad(d, ((0, 0), (0, k - kk)), constant_values=_BIG)
        i = np.pad(i, ((0, 0), (0, k - kk)), constant_values=-1)
    return d.astype(np.float32), _remap(index, i.astype(np.int32))


def pq_leaf_candidates(index, queries, n_leaves: int) -> np.ndarray:
    """(Q, n_leaves * leaf_capacity) stable ids of every series living
    in each query's `n_leaves` best leaves BY LOWER BOUND: the candidate
    universe an approx plan capped at `max_leaves=n_leaves` can ever
    return from the core (-1 marks invalid slots).  Pending delta rows
    are always additionally reachable (the delta scan stays exact):
    callers union them in.  The leaves are ordered as the plan's queue
    orders them (a stable sort, ties to the lower leaf index)."""
    core, _, _, _ = index.search_view()
    q = torch.as_tensor(np.atleast_2d(_host(queries)), device=index.device)
    _, q_paa = prepare_queries(q, index.config.znorm, core.paa.shape[1])
    lb = leaf_lower_bounds(core, q_paa, core.series.shape[1])
    n = min(n_leaves, core.n_leaves)
    leaf_order = torch.sort(lb, dim=1, stable=True).indices[:, :n]
    M = core.leaf_capacity
    members = torch.where(_live_core(core), core.perm.to(torch.int32),
                          torch.full_like(core.perm, -1, dtype=torch.int32))
    out = members.reshape(core.n_leaves, M)[leaf_order].reshape(
        leaf_order.shape[0], -1).cpu().numpy()
    alias = out >= 0
    out[alias] = _remap(index, out[alias])
    return out


def recall_at_k(result_ids: np.ndarray, oracle_ids: np.ndarray) -> float:
    """Mean fraction of each row's oracle ids present in the result row
    (-1 slots on either side never count as matches)."""
    r = np.atleast_2d(np.asarray(result_ids))
    o = np.atleast_2d(np.asarray(oracle_ids))
    hits = 0
    total = 0
    for rr, oo in zip(r, o):
        truth = set(int(v) for v in oo if v >= 0)
        if not truth:
            continue
        got = set(int(v) for v in rr if v >= 0)
        hits += len(truth & got)
        total += len(truth)
    return hits / total if total else 1.0


def holdout_queries(index, n: int = 64, noise: float = 0.25,
                    seed: int = 0) -> np.ndarray:
    """Synthesize an (n, L) held-out query sample: live indexed series
    perturbed with `noise` * per-row-std Gaussian jitter, the
    near-duplicate workload approximate search serves.  Deterministic in
    `seed`, and repro's bits for the same index and seed: the same draws
    over the same live-row order (the core's stored rows, then the live
    delta), of which only the drawn rows come to the host."""
    rng = np.random.default_rng(seed)
    core, delta, alive, _ = index.search_view()
    live_rows = torch.nonzero(_live_core(core))[:, 0]
    n_core = live_rows.shape[0]
    dx = np.zeros((0, core.series.shape[1]), np.float32)
    if delta is not None:
        dx = _host(delta)
        if alive is not None:
            dx = dx[alive.cpu().numpy().astype(bool)]
    if n_core + dx.shape[0] == 0:
        raise ValueError("cannot synthesize holdout queries from an "
                         "index with no live series")
    draw = rng.integers(0, n_core + dx.shape[0], size=n)
    base = np.empty((n, core.series.shape[1]), np.float32)
    in_core = draw < n_core
    if in_core.any():
        rows = live_rows[torch.as_tensor(draw[in_core], device=index.device)]
        base[in_core] = _host(core.series[rows])
    base[~in_core] = dx[draw[~in_core] - n_core]
    sd = base.std(axis=-1, keepdims=True)
    sd = np.where(sd > 1e-8, sd, 1.0)
    return (base + noise * sd * rng.standard_normal(base.shape)
            ).astype(np.float32)


# --------------------------------------------------------------------- #
# the table
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class CalibrationEntry:
    """One fitted setting: the rule plus the evidence behind it —
    measured recall on the holdout, mean visited-leaf fraction,
    measured per-batch latency on the calibration host, and whether the
    target was actually met (False = the exact fallback was stored)."""
    rule: StopRule
    recall: float
    visited_frac: float
    latency_us: float
    met: bool = True

    def to_dict(self) -> dict:
        return {"rule": self.rule.to_dict(), "recall": self.recall,
                "visited_frac": self.visited_frac,
                "latency_us": self.latency_us, "met": self.met}

    @classmethod
    def from_dict(cls, d: dict) -> "CalibrationEntry":
        return cls(rule=StopRule.from_dict(d["rule"]),
                   recall=float(d["recall"]),
                   visited_frac=float(d["visited_frac"]),
                   latency_us=float(d["latency_us"]),
                   met=bool(d.get("met", True)))


class CalibrationTable:
    """(k, recall_target) -> CalibrationEntry, plus the fingerprint of
    the index content the measurements were taken on.  Targets are
    keyed at 6-decimal precision so float round-trips through JSON can
    never miss a lookup."""

    def __init__(self, fingerprint: str,
                 entries: Optional[Dict[Tuple[int, float],
                                        CalibrationEntry]] = None):
        self.fingerprint = fingerprint
        self._entries: Dict[Tuple[int, float], CalibrationEntry] = \
            dict(entries or {})

    @staticmethod
    def _key(k: int, target: float) -> Tuple[int, float]:
        return (int(k), round(float(target), 6))

    def put(self, k: int, target: float, entry: CalibrationEntry) -> None:
        """Insert/replace the fitted entry for (k, target)."""
        self._entries[self._key(k, target)] = entry

    def lookup(self, k: int, target: float) -> Optional[CalibrationEntry]:
        """The fitted entry for (k, target), None when never calibrated."""
        return self._entries.get(self._key(k, target))

    def __len__(self) -> int:
        return len(self._entries)

    def items(self):
        """Iterate ((k, target), entry) pairs, sorted for stable output."""
        return sorted(self._entries.items())

    def to_dict(self) -> dict:
        """JSON-ready form (checkpoint `extra` payload)."""
        return {"fingerprint": self.fingerprint,
                "entries": [{"k": k, "target": t, **e.to_dict()}
                            for (k, t), e in self.items()]}

    @classmethod
    def from_dict(cls, d: dict) -> "CalibrationTable":
        """Inverse of `to_dict`."""
        t = cls(d["fingerprint"])
        for e in d.get("entries", ()):
            t.put(int(e["k"]), float(e["target"]),
                  CalibrationEntry.from_dict(e))
        return t

    def __repr__(self) -> str:
        return (f"CalibrationTable(entries={len(self._entries)}, "
                f"fingerprint={self.fingerprint[:8]}...)")


# --------------------------------------------------------------------- #
# the calibrator
# --------------------------------------------------------------------- #
def _default_leaves_grid(n_leaves: int, round_leaves: int
                         ) -> Tuple[int, ...]:
    """Power-of-two visited-leaf caps from one round up to half the
    tree: the frontier sweep never needs the uncapped end because the
    eps=0,uncapped point IS exact search."""
    out = []
    b = max(1, round_leaves)
    while b < n_leaves:
        out.append(b)
        b *= 2
    return tuple(out) or (max(1, n_leaves // 2),)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_setting(index, q, k: int, rule: StopRule, repeat: int
                 ) -> Tuple[np.ndarray, int, float]:
    """Execute one (rule, k) setting over the holdout through the plan
    `FreshIndex.search` runs (`search_plan_impl`, or
    `snapshot_search_impl` with a pending delta), with the knobs of
    `search_knobs()`: calibration measures the program it certifies.
    Returns (stable ids (Q, k), visited leaves, median latency seconds)."""
    kn = index.search_knobs()
    K = kn.round_leaves
    qt = torch.as_tensor(q, device=index.device)

    def run():
        return index._plan(qt, k, round_leaves=K, pq_budget=kn.pq_budget,
                           **rule.lower())

    _, i, rounds = run()                    # warmup + answers
    _sync(index.device)
    ts = []
    for _ in range(max(1, repeat)):
        t0 = time.perf_counter()
        run()
        _sync(index.device)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    budget = index.search_view()[0].n_leaves
    for cap in (kn.pq_budget, rule.max_leaves):
        if cap is not None:
            budget = min(budget, cap)
    visited = min(int(rounds) * K, budget)
    return (index._remap_ids(i).cpu().numpy().astype(np.int32), visited,
            ts[len(ts) // 2])


def calibrate(index, *, ks: Sequence[int] = (1, 5, 10),
              targets: Sequence[float] = (0.95,),
              queries=None, n_queries: int = 64, noise: float = 0.25,
              seed: int = 0,
              eps_grid: Sequence[float] = (0.0, 0.05, 0.1, 0.25, 0.5),
              leaves_grid: Optional[Sequence[int]] = None,
              repeat: int = 3) -> CalibrationTable:
    """Fit stop rules for every (k in `ks`, target in `targets`) pair.

    Sweeps the (eps_grid x leaves_grid) cross product on a held-out
    sample (`queries`, or `n_queries` synthesized near-duplicates, see
    `holdout_queries`), measures recall@k against `oracle_topk`, and
    stores the cheapest setting meeting each target (see the module
    docstring for the cost ordering).  Every setting runs the plan
    search runs, so visited-leaf counts and latencies are the real
    thing, not a model.

    Returns the fitted `CalibrationTable`; callers normally invoke this
    via `FreshIndex.calibrate(...)`, which also installs the table on
    the index so search and persistence pick it up.
    """
    for t in targets:
        if not 0.0 < t <= 1.0:
            raise ValueError(f"recall targets must be in (0, 1], got {t}")
    q = (_host(queries) if queries is not None
         else holdout_queries(index, n_queries, noise, seed))
    if q.ndim == 1:
        q = q[None]
    n_leaves = index.search_view()[0].n_leaves
    grid_leaves = (tuple(leaves_grid) if leaves_grid is not None
                   else _default_leaves_grid(
                       n_leaves, index.search_knobs().round_leaves))
    settings = [StopRule(eps=e, max_leaves=m)
                for m in grid_leaves for e in eps_grid]

    table = CalibrationTable(index_fingerprint(index))
    measured = []                           # (k, rule, recall, vf, lat)
    for k in ks:
        k = int(k)
        if k > index.n_series:
            raise ValueError(f"calibration k={k} exceeds the "
                             f"{index.n_series} live series")
        _, oracle_ids = oracle_topk(index, q, k)
        # the exact reference point last (for `met=False` fallbacks and
        # so the frontier always contains a recall=1.0 anchor)
        for rule in settings + [EXACT]:
            ids, visited, lat = _run_setting(index, q, k, rule, repeat)
            measured.append((k, rule, recall_at_k(ids, oracle_ids),
                             visited / max(1, n_leaves), lat * 1e6))

    for k in (int(k) for k in ks):
        rows = [m for m in measured if m[0] == k]
        for target in targets:
            ok = [m for m in rows if m[2] >= target]
            if ok:
                _, rule, rec, vf, lat = min(
                    ok, key=lambda m: (m[3], m[4]))
                table.put(k, target, CalibrationEntry(
                    rule=rule, recall=rec, visited_frac=vf,
                    latency_us=lat, met=True))
            else:                           # degrade to exact, loudly
                exact = next(m for m in rows if m[1].is_exact)
                table.put(k, target, CalibrationEntry(
                    rule=EXACT, recall=exact[2], visited_frac=exact[3],
                    latency_us=exact[4], met=False))
    return table
