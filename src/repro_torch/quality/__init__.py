"""Recall-tiered approximate search: stop rules (`stop_rules`) and their
offline calibration (`calibrate`), the counterpart of `repro.quality`.

The package answers every name `repro.quality` exports, each imported
from its module at first use, as `repro_torch.core` does.  `calibrate`
stays the submodule (repro's package-level `calibrate` is the function,
here `quality.calibrate.calibrate`)."""

from repro_torch import _exports

_NAMES = {
    "calibrate": ("CalibrationEntry", "CalibrationTable", "holdout_queries",
                  "index_fingerprint", "oracle_topk", "pq_leaf_candidates",
                  "recall_at_k"),
    "stop_rules": ("EXACT", "StopRule"),
}
__getattr__, __dir__ = _exports(__name__, _NAMES)
