"""Index lifecycle: tombstone masks for delete and TTL expiry, and the
policy that schedules upkeep.

* `tombstones` — the masked search view a deleted series can never win.
* `policy` — `MaintenancePolicy` and the freshness classes (HOT /
  STANDARD / ARCHIVE) that schedule TTL sweeps, compactions and
  checkpoints by staleness budget; the serving engine runs each due task
  as a journal-registered part, helped like a dispatched batch.
"""

from .policy import (ARCHIVE, HOT, STANDARD, FreshnessClass,
                     MaintenancePolicy, MaintenanceState)
from .tombstones import core_dead_mask, delta_alive_mask, mask_core

__all__ = [
    "ARCHIVE", "HOT", "STANDARD", "FreshnessClass", "MaintenancePolicy",
    "MaintenanceState",
    "core_dead_mask", "delta_alive_mask", "mask_core",
]
