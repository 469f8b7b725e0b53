"""MaintenancePolicy: freshness-tiered scheduling of background upkeep.

The port's copy of `repro.maintenance.policy` (pure Python: dataclasses
and one decision function), the same classes and the same decisions.

The engine's old knob — `auto_compact_rows` — compacts on one row count
and nothing else: TTLs never expire without an explicit call, tombstones
accumulate until someone compacts, checkpoints happen only by hand.
A `MaintenancePolicy` replaces that with per-index FRESHNESS CLASSES:
how quickly must a delete stop consuming memory, how promptly must a
TTL'd series disappear, how stale may the durable checkpoint get.

    hot       sub-second sweeps, seconds of staleness — the serving
              tier where deletes are compliance-relevant
    standard  the default: sweep every few seconds, minutes of slack
    archive   cold data: maintenance amortized over minutes

Each class bounds three clocks:

    sweep_interval_s      cadence of TTL expiry sweeps (a TTL'd series
                          stays visible at most ttl + sweep_interval)
    staleness_budget_s    max age of the OLDEST live tombstone before a
                          compaction physically drops it
    checkpoint_interval_s cadence of durable `index.save()` snapshots
                          (None = never; needs a checkpoint_dir)

plus the two space triggers compaction already understands: a pending
delta row count and a dead-row fraction of the core.

`MaintenancePolicy.due(state, ...)` is a pure function from an observed
`MaintenanceState` to the list of task kinds to run — the engine turns
each kind into a journal-registered part so a maintainer that dies
mid-task is helped like any dispatched batch (`repro_torch.serve`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

TASK_KINDS = ("sweep", "compact", "checkpoint")


@dataclasses.dataclass(frozen=True)
class FreshnessClass:
    """One tier's staleness budgets (see module docstring)."""
    name: str
    sweep_interval_s: float = 5.0
    staleness_budget_s: float = 30.0
    compact_delta_rows: int = 4096
    compact_dead_frac: float = 0.2
    checkpoint_interval_s: Optional[float] = None

    def __post_init__(self):
        if self.sweep_interval_s <= 0:
            raise ValueError("sweep_interval_s must be > 0")
        if self.staleness_budget_s <= 0:
            raise ValueError("staleness_budget_s must be > 0")
        if self.compact_delta_rows < 1:
            raise ValueError("compact_delta_rows must be >= 1")
        if not (0.0 < self.compact_dead_frac <= 1.0):
            raise ValueError("compact_dead_frac must be in (0, 1]")
        if (self.checkpoint_interval_s is not None
                and self.checkpoint_interval_s <= 0):
            raise ValueError("checkpoint_interval_s must be > 0 or None")


HOT = FreshnessClass("hot", sweep_interval_s=0.2, staleness_budget_s=2.0,
                     compact_delta_rows=512, compact_dead_frac=0.05)
STANDARD = FreshnessClass("standard")
ARCHIVE = FreshnessClass("archive", sweep_interval_s=60.0,
                         staleness_budget_s=600.0,
                         compact_delta_rows=65536, compact_dead_frac=0.5)


@dataclasses.dataclass(frozen=True)
class MaintenanceState:
    """One consistent observation of the index's upkeep-relevant state —
    what the engine samples under its condition variable and hands to
    `MaintenancePolicy.due` (all host ints/floats, no device work)."""
    n_base: int                     # physical core rows
    delta_rows: int                 # pending (uncompacted) delta rows
    dead_rows: int                  # live tombstones (not yet dropped)
    ttl_entries: int                # series with a pending TTL
    oldest_tombstone_age_s: float   # 0.0 when no live tombstone
    since_sweep_s: float
    since_checkpoint_s: float


@dataclasses.dataclass(frozen=True)
class MaintenancePolicy:
    """Which upkeep runs, and when — the `EngineConfig.maintenance` knob.

    freshness        the FreshnessClass budgets (HOT/STANDARD/ARCHIVE or
                     a custom instance)
    checkpoint_dir   directory for policy-driven `index.save()` snapshots
                     (None disables checkpointing even if the class sets
                     an interval)
    checkpoint_interval_s
                     overrides the class's checkpoint cadence

    Migration from `auto_compact_rows=n`:
    `MaintenancePolicy.compact_every(n)` compacts at the same row count
    and additionally sweeps TTLs / drops tombstones on the standard
    budgets (see the README migration table).
    """
    freshness: FreshnessClass = STANDARD
    checkpoint_dir: Optional[str] = None
    checkpoint_interval_s: Optional[float] = None

    def __post_init__(self):
        if (self.checkpoint_interval_s is not None
                and self.checkpoint_interval_s <= 0):
            raise ValueError("checkpoint_interval_s must be > 0 or None")

    @classmethod
    def compact_every(cls, rows: int, *,
                      freshness: FreshnessClass = STANDARD
                      ) -> "MaintenancePolicy":
        """The `auto_compact_rows` migration shim: same delta-row
        compaction trigger, plus the tier's sweep/staleness budgets."""
        if rows < 1:
            raise ValueError("rows must be >= 1")
        return cls(freshness=dataclasses.replace(
            freshness, compact_delta_rows=rows))

    # ------------------------------------------------------------------ #
    def checkpoint_cadence(self) -> Optional[float]:
        """Effective checkpoint interval (None = checkpointing off)."""
        if self.checkpoint_dir is None:
            return None
        if self.checkpoint_interval_s is not None:
            return self.checkpoint_interval_s
        return self.freshness.checkpoint_interval_s

    def due(self, state: MaintenanceState) -> Tuple[str, ...]:
        """Task kinds due under `state`, in execution order.

        Pure and deterministic: same state -> same answer, so the
        checker can replay scheduling decisions across interleavings.
        Sweeps order before compactions — a sweep converts expired TTLs
        into tombstones the same cycle's compaction can then drop.
        """
        f = self.freshness
        out = []
        if state.ttl_entries > 0 \
                and state.since_sweep_s >= f.sweep_interval_s:
            out.append("sweep")
        dead_frac = (state.dead_rows / state.n_base
                     if state.n_base else 0.0)
        if (state.delta_rows >= f.compact_delta_rows
                or (state.dead_rows > 0
                    and (state.oldest_tombstone_age_s
                         >= f.staleness_budget_s
                         or dead_frac >= f.compact_dead_frac))):
            out.append("compact")
        cadence = self.checkpoint_cadence()
        if cadence is not None and state.since_checkpoint_s >= cadence:
            out.append("checkpoint")
        return tuple(out)
