"""Search-knob autotune: sweep the knobs that change no answer on the live
device and cache the winner next to checkpoints.

The profitable `round_leaves` (leaves refined per query per round) and a
`pq_budget` that cuts nothing are facts of the device and the index, not
index semantics, so they are measured: `autotune_index` enumerates
candidate `TuneConfig`s (`candidate_space`), times each through the plan
`FreshIndex.search` runs, and stores the fastest in an `AutotuneTable`
keyed by `(device_kind, L, leaf_capacity, dtype)`.  `FreshIndex` persists
the table with its checkpoint (`extra["autotune"]`, repro's format) and
resolves UNSET IndexConfig knobs through it (`FreshIndex.search_knobs`);
a key miss (an unknown device, another series length) falls back to the
static defaults, so an untuned index behaves exactly as before.

Exactness gate: a candidate may be timed only if its search output is
BITWISE the default-knob output on the index's own device; tuned search
is therefore bit-identical to untuned search by construction.  (The CPU
tests hold the gate on the plain versions.)

Staleness: the table records the `index_fingerprint` of the content it
was measured on; `FreshIndex` resolves nothing through a stale table.

The counterpart of `repro.kernels.autotune`.  Its `dma_depth` and
`block_q` are Pallas structure knobs the port's kernels do not have:
`TuneConfig.from_dict` ignores them with any other unknown key, and
`candidate_space` takes no lowering.  `device_kind` is the card's name
(`torch.cuda.get_device_name`) or "cpu", so a table measured on a TPU or
on the CPU never resolves on the card.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, Optional, Sequence, Tuple

import torch

#: the static defaults every knob falls back to when neither IndexConfig
#: nor a fresh AutotuneTable sets it
DEFAULTS: Dict[str, Optional[int]] = {
    "round_leaves": 8,
    "pq_budget": None,
}


@dataclasses.dataclass(frozen=True)
class TuneConfig:
    """One fully-resolved setting of the sweepable search knobs.

    round_leaves  leaves refined per query per round
    pq_budget     PQ admission cap (None = exact full budget); a finite
                  value only survives the sweep's bitwise gate when it
                  provably changes nothing on this index
    """
    round_leaves: int = 8
    pq_budget: Optional[int] = None

    def to_dict(self) -> dict:
        """Plain-dict form (JSON / checkpoint payload)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TuneConfig":
        """Inverse of `to_dict`, or repro's dict; unknown keys (repro's
        dma_depth and block_q) ignored."""
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass(frozen=True)
class TuneEntry:
    """One table row: the winning config plus the evidence behind it —
    its median latency, the default-knob baseline it beat (or tied),
    and how many of the swept candidates survived the bitwise gate."""
    config: TuneConfig
    median_ms: float
    baseline_ms: float
    n_candidates: int
    n_exact: int

    def to_dict(self) -> dict:
        return {"config": self.config.to_dict(),
                "median_ms": self.median_ms,
                "baseline_ms": self.baseline_ms,
                "n_candidates": self.n_candidates,
                "n_exact": self.n_exact}

    @classmethod
    def from_dict(cls, d: dict) -> "TuneEntry":
        return cls(config=TuneConfig.from_dict(d["config"]),
                   median_ms=float(d["median_ms"]),
                   baseline_ms=float(d["baseline_ms"]),
                   n_candidates=int(d["n_candidates"]),
                   n_exact=int(d["n_exact"]))


def device_kind(device) -> str:
    """The kind string of `device`, the table's first key part: the
    card's name on CUDA (`torch.cuda.get_device_name`), else the device
    type ("cpu").  Lookups and stores go through this one helper so they
    can never disagree on spelling."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


class AutotuneTable:
    """(device_kind, L, leaf_capacity, dtype) -> TuneEntry, plus the
    fingerprint of the index content the timings were measured on
    (mirrors `quality.calibrate.CalibrationTable`)."""

    def __init__(self, fingerprint: str,
                 entries: Optional[Dict[Tuple[str, int, int, str],
                                        TuneEntry]] = None):
        self.fingerprint = fingerprint
        self._entries: Dict[Tuple[str, int, int, str], TuneEntry] = \
            dict(entries or {})

    @staticmethod
    def _key(device: str, L: int, leaf_capacity: int,
             dtype: str) -> Tuple[str, int, int, str]:
        return (str(device), int(L), int(leaf_capacity), str(dtype))

    def put(self, device: str, L: int, leaf_capacity: int, dtype: str,
            entry: TuneEntry) -> None:
        """Insert/replace the winner for one device/shape key."""
        self._entries[self._key(device, L, leaf_capacity, dtype)] = entry

    def lookup(self, device: str, L: int, leaf_capacity: int,
               dtype: str) -> Optional[TuneEntry]:
        """The tuned entry for this key; None (-> static defaults) when
        the device/shape was never swept: the unknown-device fallback."""
        return self._entries.get(self._key(device, L, leaf_capacity, dtype))

    def __len__(self) -> int:
        return len(self._entries)

    def items(self):
        """Iterate (key, entry) pairs, sorted for stable output."""
        return sorted(self._entries.items())

    def to_dict(self) -> dict:
        """JSON-ready form (checkpoint `extra["autotune"]` payload)."""
        return {"fingerprint": self.fingerprint,
                "entries": [{"device": k[0], "L": k[1],
                             "leaf_capacity": k[2], "dtype": k[3],
                             **e.to_dict()}
                            for k, e in self.items()]}

    @classmethod
    def from_dict(cls, d: dict) -> "AutotuneTable":
        """Inverse of `to_dict` (repro's tables too)."""
        t = cls(d["fingerprint"])
        for e in d.get("entries", ()):
            t.put(e["device"], int(e["L"]), int(e["leaf_capacity"]),
                  e["dtype"], TuneEntry.from_dict(e))
        return t

    def save_json(self, path: str) -> None:
        """Write the table as JSON (FreshIndex.save embeds `to_dict` in
        the checkpoint manifest instead)."""
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def load_json(cls, path: str) -> "AutotuneTable":
        """Inverse of `save_json`."""
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def __repr__(self) -> str:
        return (f"AutotuneTable(entries={len(self._entries)}, "
                f"fingerprint={self.fingerprint[:8]}...)")


def resolve_knobs(config, entry: Optional[TuneEntry] = None) -> TuneConfig:
    """The one knob-resolution chain: explicit IndexConfig field (not
    None) > fresh tuned entry > static `DEFAULTS`.  `config` may be None
    (pure table/default resolution); callers pass `entry=None` for the
    unknown-device / stale-table fallback and get the defaults."""
    t = entry.config if entry is not None else None

    def pick(name):
        v = getattr(config, name, None) if config is not None else None
        if v is not None:
            return v
        if t is not None:
            return getattr(t, name)
        return DEFAULTS[name]

    return TuneConfig(round_leaves=pick("round_leaves"),
                      pq_budget=pick("pq_budget"))


def candidate_space(*, quick: bool = False,
                    round_leaves_grid: Optional[Sequence[int]] = None,
                    pq_budgets: Sequence[Optional[int]] = (None,)
                    ) -> Tuple[TuneConfig, ...]:
    """Enumerate the sweep's candidate TuneConfigs: `round_leaves_grid`
    crossed with `pq_budgets`.  `quick` shrinks the grid to two points.
    The default config is always candidate 0, so the sweep can never
    return an empty or all-rejected space."""
    if round_leaves_grid is None:
        round_leaves_grid = (8, 16) if quick else (4, 8, 16)
    out = [TuneConfig()]
    for rl in round_leaves_grid:
        for pq in pq_budgets:
            out.append(TuneConfig(round_leaves=rl, pq_budget=pq))
    seen, uniq = set(), []
    for c in out:
        if c not in seen:
            seen.add(c)
            uniq.append(c)
    return tuple(uniq)


def _run_tuned(index, q: torch.Tensor, k: int, tc: TuneConfig):
    """One setting over the query batch through the plan search runs;
    returns the (Q, k) (dist, ids) on the index's device."""
    d, i, _ = index._plan(q, k, round_leaves=tc.round_leaves,
                          pq_budget=tc.pq_budget)
    return d, i


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_tuned(index, q: torch.Tensor, k: int, tc: TuneConfig,
                repeat: int) -> float:
    """Median wall-clock seconds of one setting (warmup excluded)."""
    _run_tuned(index, q, k, tc)
    _sync(index.device)
    ts = []
    for _ in range(max(1, repeat)):
        t0 = time.perf_counter()
        _run_tuned(index, q, k, tc)
        _sync(index.device)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def _bits(d: torch.Tensor, i: torch.Tensor) -> Tuple[bytes, bytes]:
    """The bitwise identity of a search answer (gate currency)."""
    return (d.cpu().numpy().tobytes(),
            i.to(torch.int32).cpu().numpy().tobytes())


def autotune_index(index, *, queries=None, n_queries: int = 32,
                   k: int = 5, repeat: int = 3, quick: bool = False,
                   candidates: Optional[Sequence[TuneConfig]] = None,
                   seed: int = 0) -> AutotuneTable:
    """Sweep search-knob candidates on the index's device and return the
    winner as a one-entry AutotuneTable for this index's key.

    Each candidate is first GATED: its search output must be bitwise
    identical to the default-knob output over the holdout batch;
    survivors are timed (`repeat` runs, median, warmup excluded) and the
    fastest wins.  The default config always survives its own gate, so
    the sweep always produces a winner.

    Args:
        index: the FreshIndex to tune (read-only).
        queries: explicit (Q, L) holdout batch; None synthesizes
            `n_queries` near-duplicates (`quality.holdout_queries`).
        n_queries: synthesized-holdout size when `queries` is None.
        k: result count the sweep times.
        repeat: timed runs per surviving candidate (median taken).
        quick: shrink the candidate grid to two points
            (`candidate_space`).
        candidates: explicit candidate list, the default config among
            them (None = `candidate_space`).
        seed: holdout synthesis seed.
    Returns:
        AutotuneTable with one entry under this index's
        (device_kind, L, leaf_capacity, dtype) key, fingerprinted
        against the index content.
    """
    from repro_torch.quality.calibrate import (holdout_queries,
                                               index_fingerprint)

    q = (torch.as_tensor(queries, dtype=torch.float32)
         if queries is not None
         else torch.from_numpy(holdout_queries(index, n_queries,
                                               seed=seed)))
    if q.dim() == 1:
        q = q[None]
    q = q.to(index.device)
    k = min(int(k), int(index.n_series))
    cands = (tuple(candidates) if candidates is not None
             else candidate_space(quick=quick))

    base = TuneConfig()
    ref_bits = _bits(*_run_tuned(index, q, k, base))
    survivors = [tc for tc in cands
                 if tc == base
                 or _bits(*_run_tuned(index, q, k, tc)) == ref_bits]

    timed = [(_time_tuned(index, q, k, tc, repeat), tc) for tc in survivors]
    baseline_s = next(t for t, tc in timed if tc == base)
    best_s, best = min(timed, key=lambda p: p[0])

    table = AutotuneTable(index_fingerprint(index))
    cfg = index.config
    table.put(device_kind(index.device), index.series_len,
              cfg.leaf_capacity, cfg.dtype,
              TuneEntry(config=best, median_ms=best_s * 1e3,
                        baseline_ms=baseline_s * 1e3,
                        n_candidates=len(cands), n_exact=len(survivors)))
    return table
