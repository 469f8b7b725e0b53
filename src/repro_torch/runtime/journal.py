"""Cluster-level Refresh: a persistent work journal with helping.

The port's copy of `repro.runtime.journal` (which the port cannot import:
`repro`'s package imports jax), with the same JSON file format, so each
package reads the journal file the other wrote.

This is the distributed adaptation of the paper's core mechanism (DESIGN.md
§2).  The workload (an epoch of data chunks, an index-build partition, ...)
is split into parts; each part has a done flag and an owner.  Workers:

  1. acquire parts they own and process them (EXPEDITIVE mode — no
     coordination beyond the atomic acquire);
  2. when their own parts are exhausted, they SCAN the journal for
     unfinished parts, BACK OFF proportionally to the measured mean part
     time (the paper's T_avg rule, Section V-A), and then HELP: re-execute
     parts whose owner looks dead or slow (STANDARD mode).

Processing must be idempotent (the traversing property only demands
at-least-once application) — true for both data loading (a re-served chunk
re-enters the batch stream after a crash; exactly-once is restored by the
step counter in the checkpoint) and index building (inserting the same
series twice is deduplicated by series id).

The journal is a JSON file updated with atomic rename, so a restarted
worker (or a helper on another host) sees a consistent snapshot — the
durable analogue of the paper's shared-memory done flags.  Callers that
defer the write (autopersist=False) capture `snapshot()` under the same
lock that guards their mutations and hand it to `persist(state)` after
release: the file write then touches only the captured copy, never the
live journal, and a sequence stamp keeps a delayed older write from
clobbering a newer one.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.analysis.hooks import observe, sync_point


@dataclass
class PartState:
    owner: int = -1
    done: bool = False
    acquired_at: float = 0.0
    done_at: float = 0.0
    attempts: int = 0
    helped: bool = False


class WorkJournal:
    """Per-stage chunk journal.  Single-writer-per-part semantics with
    atomic whole-file persistence (rename).

    Part ids are GLOBAL and stable: a streaming producer (the serving
    layer registers one part per dispatched batch) can prune_done() the
    completed prefix so the resident window — and every scan — stays
    bounded by the in-flight work, while ids keep counting up and the
    cumulative stats survive pruning."""

    def __init__(self, path: Optional[str], n_parts: int,
                 backoff_factor: float = 2.0, autopersist: bool = True):
        self.path = path
        self.n_parts = n_parts                  # total parts ever created
        self.backoff_factor = backoff_factor
        # autopersist=False defers the on-disk write to an explicit
        # persist() call: callers that mutate the journal under a lock
        # (QueryEngine under its condition variable) must not do file
        # I/O there — they persist after releasing it.  Durability is
        # unchanged in kind: a part marked done but lost to a crash
        # before persist() is simply re-executed (at-least-once helping).
        self.autopersist = autopersist
        self.parts: List[PartState] = [PartState() for _ in range(n_parts)]
        self._base = 0                          # ids below this are pruned
        self._pruned_helped = 0                 # stats carried past pruning
        self._pruned_attempts = 0
        self._t_avg = 0.0
        self._t_cnt = 0
        # deferred-persist machinery: every snapshot() is stamped with a
        # sequence number so a delayed write can never regress the file
        # past a newer one; _wmu serializes only the compare-and-write
        # (file I/O — mutators never take it)
        self._seq = 0
        self._written_seq = -1
        self._wmu = threading.Lock()
        if path and os.path.exists(path):
            self._load()

    # ---------------------------------------------------- dynamic growth
    def add_part(self) -> int:
        """Append one part to an open-ended journal and return its id.

        Fixed workloads (an epoch of chunks) size the journal up front;
        streaming producers grow it one part per unit of work.  Construct
        with n_parts=0 for a purely dynamic journal (reloads then adopt
        the persisted part count)."""
        sync_point("journal.add_part", self)
        self.parts.append(PartState())
        self.n_parts = self._base + len(self.parts)
        self._persist()
        return self.n_parts - 1

    def part(self, pid: int) -> PartState:
        """The state of global part id `pid` (must not be pruned away)."""
        if pid < self._base:
            raise IndexError(
                f"part {pid} was pruned (done); window starts at "
                f"{self._base} — query is_done() for completion state")
        return self.parts[pid - self._base]

    def is_done(self, pid: int) -> bool:
        """Completion state that survives pruning: only DONE parts are
        ever pruned, so a pruned id is done by definition.  Helpers that
        lost a race to a faster executor must use this, not part()."""
        if pid < self._base:
            return True
        return self.parts[pid - self._base].done

    def prune_done(self) -> int:
        """Drop the longest DONE prefix of the window; returns how many.

        Ids stay global, cumulative stats are preserved — only the
        per-part state of long-finished work is released, keeping
        acquire()/unfinished() scans O(in-flight) on an endless stream."""
        sync_point("journal.prune", self)
        n = 0
        while n < len(self.parts) and self.parts[n].done:
            self._pruned_helped += self.parts[n].helped
            self._pruned_attempts += self.parts[n].attempts
            n += 1
        if n:
            del self.parts[:n]
            self._base += n
            self._persist()
        return n

    # ------------------------------------------------------------ owner
    def acquire(self, worker: int) -> Optional[int]:
        """Next unowned part (FAI-style); None when all are owned.

        NOT internally synchronized: concurrent bare acquires can both
        claim one part (benign — processing is idempotent and helpers
        re-check is_done before delivering effects).  The serving engine
        serializes journal calls under its condition variable; the
        standalone race checker explores exactly this window via the
        journal.acquire.claim sync point."""
        sync_point("journal.acquire", worker)
        for i, p in enumerate(self.parts):
            if p.owner < 0 and not p.done:
                sync_point("journal.acquire.claim", self._base + i)
                p.owner = worker
                p.acquired_at = time.time()
                p.attempts += 1
                self._persist()
                return self._base + i
        return None

    def mark_done(self, part: int) -> None:
        sync_point("journal.mark_done", part)
        p = self.part(part)
        if not p.done:
            p.done = True
            p.done_at = time.time()
            if p.acquired_at:
                dt = p.done_at - p.acquired_at
                self._t_cnt += 1
                self._t_avg += (dt - self._t_avg) / self._t_cnt
            self._persist()

    def discard(self, part: int) -> None:
        """Retire `part` as done WITHOUT executing it — and without
        feeding its wall-clock age into the T_avg helping estimate.

        For work that can no longer produce an effect: a part reloaded
        from a crashed process's journal whose consumer (the serving
        engine's in-memory batch and the futures it fed) died with that
        process.  Leaving such a part unfinished would make every helper
        re-steal it forever — nobody can ever mark it done by executing
        it."""
        sync_point("journal.discard", part)
        p = self.part(part)
        if not p.done:
            p.done = True
            p.done_at = time.time()
            self._persist()

    # ----------------------------------------------------------- helping
    def backoff_deadline(self) -> float:
        """Paper's rule: help only after backoff ∝ measured T_avg."""
        return self.backoff_factor * max(self._t_avg, 1e-3)

    def help_candidates(self, now: Optional[float] = None) -> List[int]:
        """Unfinished parts whose owner has exceeded the backoff deadline
        (or that were never acquired) — the helper's scan (Alg. 2 l.12)."""
        now = now if now is not None else time.time()
        ddl = self.backoff_deadline()
        out = []
        for i, p in enumerate(self.parts):
            if p.done:
                continue
            if p.owner < 0 or (now - p.acquired_at) > ddl:
                out.append(self._base + i)
        return out

    def steal(self, part: int, helper: int) -> None:
        sync_point("journal.steal", part)
        p = self.part(part)
        p.owner = helper
        p.acquired_at = time.time()
        p.attempts += 1
        p.helped = True
        self._persist()

    def all_done(self) -> bool:
        return all(p.done for p in self.parts)

    def unfinished(self) -> List[int]:
        return [self._base + i
                for i, p in enumerate(self.parts) if not p.done]

    def stats(self) -> dict:
        return {
            "n_parts": self.n_parts,
            "pruned": self._base,
            "done": self._base + sum(p.done for p in self.parts),
            "helped": self._pruned_helped + sum(p.helped
                                                for p in self.parts),
            "attempts": self._pruned_attempts + sum(p.attempts
                                                    for p in self.parts),
            "t_avg": self._t_avg,
        }

    # -------------------------------------------------------- persistence
    def snapshot(self) -> Optional[dict]:
        """A self-consistent serialized COPY of the journal state (None
        when the journal has no backing path).

        Must be called under the same lock that guards this journal's
        mutations (the engine's condition variable; single-threaded
        callers trivially qualify).  The copy is what makes a deferred
        persist safe: the later file write reads only this dict, never
        the live journal, so racing mutators cannot tear base / n_parts
        / part states apart mid-write and misalign part states with
        their global ids in the file."""
        if not self.path:
            return None
        self._seq += 1
        return {"seq": self._seq,
                "n_parts": self.n_parts, "base": self._base,
                "pruned_helped": self._pruned_helped,
                "pruned_attempts": self._pruned_attempts,
                "t_avg": self._t_avg, "t_cnt": self._t_cnt,
                "parts": [vars(p).copy() for p in self.parts]}

    def persist(self, state: Optional[dict] = None) -> None:
        """Write the journal to disk now (no-op without a path) — the
        explicit flush point for autopersist=False journals.  Call it
        OUTSIDE any lock the journal is mutated under, passing the
        `snapshot()` captured while that lock WAS held; `state=None`
        captures one at the call (fine for single-threaded callers)."""
        if not self.path:
            return
        self._write(state if state is not None else self.snapshot())

    def _persist(self) -> None:
        if self.autopersist:
            # inline flush inside the mutator: the snapshot is built
            # under whatever synchronization the caller mutates this
            # journal under, so it is as consistent as the mutation
            self._write(self.snapshot())

    def _write(self, state: Optional[dict]) -> None:
        if not self.path or state is None:
            return
        observe("journal.persist", self.path)
        seq = state.pop("seq", self._seq)
        d = os.path.dirname(self.path) or "."
        with self._wmu:
            if seq < self._written_seq:
                return      # a newer snapshot already reached the disk
            self._written_seq = seq
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=d)
            with os.fdopen(fd, "w") as f:
                json.dump(state, f)
            os.replace(tmp, self.path)      # atomic on POSIX

    def _load(self) -> None:
        with open(self.path) as f:
            data = json.load(f)
        if self.n_parts == 0:                 # dynamic journal: adopt file
            self.n_parts = data["n_parts"]
        assert data["n_parts"] == self.n_parts, \
            "journal/workload mismatch (elastic re-partition not supported " \
            "mid-stage; finish or clear the stage first)"
        self._base = data.get("base", 0)
        self._pruned_helped = data.get("pruned_helped", 0)
        self._pruned_attempts = data.get("pruned_attempts", 0)
        self._t_avg = data.get("t_avg", 0.0)
        self._t_cnt = data.get("t_cnt", 0)
        self.parts = [PartState(**p) for p in data["parts"]]
        # crash recovery: surviving owners re-acquire; stale ownership is
        # cleared so restarted workers do not wait on the dead
        for p in self.parts:
            if not p.done:
                p.owner = -1
