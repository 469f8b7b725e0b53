"""Early-termination stop rules for the refinement rounds.

The refinement finds good candidates long before it proves that no better
one exists, and spends its tail proving a negative.  A `StopRule` names
the two ways to cut that tail:

* `eps`: stop once no unrefined priority-queue slot has a lower bound
  below `bsf / (1 + eps)`, so no remaining candidate could improve the
  k-th answer by more than the (1+eps) factor.  The comparison is in
  squared space, `lb >= bsf^2 / (1+eps)^2`, inside the refine_search
  kernel.
* `max_leaves`: a hard visited-leaf cap, folded into the PQ leaf budget.

Both lower to the plan knobs `stop_eps` / `stop_leaves` of
`repro_torch.core.search.search_plan_impl`, and `StopRule()` (the `EXACT`
sentinel) lowers to the exact search, bit for bit.

The counterpart of `repro.quality.stop_rules`, a copy of it (stdlib only,
so `quality` sits above `core`, which takes the knobs as plain scalars).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["StopRule", "EXACT"]


@dataclasses.dataclass(frozen=True)
class StopRule:
    """One early-termination setting: `eps` BSF-convergence slack plus a
    `max_leaves` visited-leaf cap (None = uncapped).  Frozen and hashable,
    so a rule can key calibration tables directly.

    The defaults (0.0, None) are EXACT mode: `is_exact` is True and
    `lower()` gives the knobs under which search is the exact search."""

    eps: float = 0.0
    max_leaves: Optional[int] = None

    def __post_init__(self):
        if not (self.eps >= 0.0):        # also rejects NaN
            raise ValueError(f"eps must be >= 0, got {self.eps}")
        if self.max_leaves is not None and self.max_leaves < 1:
            raise ValueError(
                f"max_leaves must be >= 1 or None, got {self.max_leaves}")

    @property
    def is_exact(self) -> bool:
        """True when this rule never terminates early (the exact plan)."""
        return self.eps == 0.0 and self.max_leaves is None

    def lower(self) -> dict:
        """The plan knobs this rule lowers to: splat into
        `search_plan_impl` / `run_search` calls as `**rule.lower()`."""
        return {"stop_eps": float(self.eps), "stop_leaves": self.max_leaves}

    def to_dict(self) -> dict:
        """JSON-ready form (CalibrationTable persistence)."""
        return {"eps": float(self.eps), "max_leaves": self.max_leaves}

    @classmethod
    def from_dict(cls, d: dict) -> "StopRule":
        """Inverse of `to_dict` (unknown keys ignored for forward
        compatibility with newer checkpoint writers)."""
        return cls(eps=float(d.get("eps", 0.0)),
                   max_leaves=(None if d.get("max_leaves") is None
                               else int(d["max_leaves"])))

    def __str__(self) -> str:
        if self.is_exact:
            return "exact"
        return f"eps={self.eps:g},max_leaves={self.max_leaves}"


EXACT = StopRule()
