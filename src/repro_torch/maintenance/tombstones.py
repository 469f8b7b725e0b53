"""Tombstone masking: a logically deleted series must never win top-k.

The port's counterpart of `repro.maintenance.tombstones`.  The search
reads five core fields (series, sq_norms, perm, leaf_lo, leaf_hi) and
already has a row class it never selects: padding rows, whose squared
norm is the 1e30 sentinel (their matmul-form distances come out >= BIG,
so they lose every fold).  Tombstoning reuses that:

* CORE rows: a derived view replaces `sq_norms` with the sentinel on
  dead rows (`mask_core`).  Every other array is shared and the stored
  index stays byte-identical.  Leaf bounds keep counting dead rows: a
  stale bound is a looser LOWER bound, so the search stays exact.  The
  mask is built on the index's device (`torch.isin` on perm).

* DELTA rows: the delta is scanned raw and z-normalized inside the scan,
  so dead delta rows carry an explicit alive mask (`delta_alive_mask`)
  that `core.search._bruteforce_topk` applies after normalization.

Both derive from one host-side tombstone id set owned by `FreshIndex`;
ids are stable and never reused.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from repro_torch.core.index import FlatIndex

# the padding rows' sentinel norm, core.search's BIG
DEAD_NORM = 1e30


def _ids(ids: Iterable[int], device) -> torch.Tensor:
    return torch.as_tensor(sorted(int(i) for i in ids), dtype=torch.int64,
                           device=device)


def core_dead_mask(perm: torch.Tensor, tombstones: Iterable[int]
                   ) -> torch.Tensor:
    """(n_rows,) bool on perm's device: True where the core row's series
    id is tombstoned (padding rows carry -1 and never match)."""
    tomb = _ids(tombstones, perm.device)
    if tomb.numel() == 0:
        return torch.zeros(perm.shape[0], dtype=torch.bool,
                           device=perm.device)
    return torch.isin(perm.long(), tomb)


def mask_core(core: FlatIndex, dead_rows: torch.Tensor) -> FlatIndex:
    """A search view of `core` whose dead rows can never be selected: their
    `sq_norms` become the padding sentinel; every other field is shared
    with the stored index."""
    if not bool(dead_rows.any()):
        return core
    return core._replace(sq_norms=torch.where(
        dead_rows, torch.full_like(core.sq_norms, DEAD_NORM), core.sq_norms))


def delta_alive_mask(n_rows: int, delta_id0: int,
                     tombstones: Iterable[int], device
                     ) -> Optional[torch.Tensor]:
    """(n_rows,) bool on `device`, False on tombstoned delta positions
    (position p holds series id delta_id0 + p); None when all are alive."""
    dead = [t - delta_id0 for t in tombstones if 0 <= t - delta_id0 < n_rows]
    if not dead:
        return None
    alive = torch.ones(n_rows, dtype=torch.bool, device=device)
    alive[torch.as_tensor(dead, dtype=torch.int64, device=device)] = False
    return alive
