"""Runtime of the port: the work journal with helping.

    journal   — WorkJournal / PartState: persistent done-flags with the
                paper's backoff-then-help rule (T_avg, Section V-A); the
                serving engine registers every dispatched batch as a part

`repro.runtime`'s elastic re-meshing and mesh identity belong to sharded
serving, which the port does not have yet.
"""

from .journal import PartState, WorkJournal  # noqa: F401

__all__ = ["PartState", "WorkJournal"]
