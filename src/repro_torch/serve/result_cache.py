"""Epoch-keyed LRU result cache for the serving layer.

The port's copy of `repro.serve.result_cache`: `query_fingerprint`
hashes a row's float32 bytes, so it equals repro's on the same row.

The engine's snapshots are immutable Jiffy-style epochs: every
`add()`/`compact()`/`recover()` publishes a NEW epoch number and never
mutates the tensors behind an old one.  That makes result caching
trivially coherent: a cache entry keyed by `(query_bytes_hash, epoch, k,
knobs)` is *provably* fresh for as long as any caller can still submit
against that epoch, because a submit after the next `add()` carries a
different epoch and therefore a different key.  No invalidation hooks,
no TTLs: epoch advance IS the invalidation, for free, and stale entries
age out of the LRU.  Deletion rides the same contract: `engine.delete()`
and TTL expiry publish a new epoch too (asserted in the engine), so a
cached row can never resurrect a deleted or expired series.

Entries store the exact numpy rows the engine delivered to the filling
future, so a hit is bit-identical to a cold plan execution on the same
epoch.

Thread-safety: NOT internally locked.  The engine calls get()/put()
only while holding its condition variable; every operation here is O(1)
dict work (the blake2b hashing of query bytes happens in the engine,
outside the lock), so nothing here can stall readers or writers.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

__all__ = ["ResultCache", "query_fingerprint"]


def query_fingerprint(row: np.ndarray) -> bytes:
    """Stable 16-byte digest of one query row's float32 bytes.

    Hashing the raw bytes (not a float tuple) keeps -0.0 vs 0.0 and NaN
    payloads distinct exactly the way the plans would see them.
    """
    return hashlib.blake2b(np.ascontiguousarray(row, np.float32).tobytes(),
                           digest_size=16).digest()


class ResultCache:
    """Bounded LRU over `(query_fingerprint, epoch, k, knobs)` keys.

    Values are `(d_row, i_row)` numpy pairs — one query row's top-k
    distances and ids, copied at fill time so later reuse of
    the plans' output buffers can never corrupt a cached answer.  Capacity is
    counted in entries (rows), the eviction order is least-recently-hit,
    and the hit/miss/fill/eviction counters feed
    ``QueryEngine.stats()["result_cache"]``.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("result cache capacity must be >= 1")
        self.capacity = capacity
        self._entries: "OrderedDict[tuple, Tuple[np.ndarray, np.ndarray]]" \
            = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.fills = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: tuple) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Return the cached `(d_row, i_row)` for `key`, else None.

        A hit refreshes the entry's LRU position.  Counts every call as
        a hit or a miss — the engine consults the cache once per
        submitted row, so the counters read as row rates.
        """
        hit = self._entries.get(key)
        if hit is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return hit

    def put(self, key: tuple, d_row: np.ndarray, i_row: np.ndarray) -> None:
        """Insert (or refresh) `key` -> copies of `(d_row, i_row)`,
        evicting the least-recently-used entry past capacity."""
        if key in self._entries:
            self._entries.move_to_end(key)
            return
        self._entries[key] = (np.array(d_row, copy=True),
                              np.array(i_row, copy=True))
        self.fills += 1
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1

    def stats(self) -> dict:
        """Counter snapshot: hits/misses/fills/evictions/entries/capacity."""
        return {"hits": self.hits, "misses": self.misses,
                "fills": self.fills, "evictions": self.evictions,
                "entries": len(self._entries), "capacity": self.capacity}

    def __repr__(self) -> str:
        return (f"ResultCache(entries={len(self._entries)}, "
                f"capacity={self.capacity}, hits={self.hits}, "
                f"misses={self.misses})")
