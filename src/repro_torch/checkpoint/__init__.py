"""Checkpoints of the port, in the layout `repro.checkpoint` writes.

The package answers every name `repro.checkpoint` exports, each imported
from `store` at first use, as `repro_torch.core` does."""

from repro_torch import _exports

_NAMES = {"store": ("CheckpointManager", "load_arrays", "load_checkpoint",
                    "save_checkpoint")}
__getattr__, __dir__ = _exports(__name__, _NAMES)
