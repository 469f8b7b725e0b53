"""The SyncHook seam: how a race checker gets between the threads.

The port's copy of `repro.analysis.hooks` (which the port cannot import:
`repro`'s package imports jax).  The lock-free core (core/refresh.py)
calls two module-level functions at its synchronization points:

    sync_point(name, obj=None)   SCHEDULABLE: under a controlled scheduler
                                 the calling thread may be parked here and
                                 another thread run instead.  Placement
                                 rule: a sync_point must NEVER be reached
                                 while the thread holds a Python lock —
                                 a parked lock-holder would deadlock every
                                 thread blocked on that lock (they block
                                 inside the lock, invisible to the
                                 scheduler).  Put points just BEFORE lock
                                 acquisition and just AFTER release; the
                                 critical sections themselves are mutually
                                 exclusive anyway, so ordering who enters
                                 is enough to explore their interleavings.
    observe(name, obj=None)      NON-PARKING: pure bookkeeping for
                                 invariant checking (snapshot publish/GC
                                 fingerprints, future fills, journal
                                 persistence).  Safe anywhere, including
                                 under locks.

With no hook installed (production, the normal test suite) both are one
global load + a None check — measured ~40ns, free compared to the payloads
they bracket.  `set_sync_hook` installs a `SyncHook`; repro's race
checker's `ControlledHook` is the interesting implementation.

Hooks apply process-wide but a ControlledHook only ever parks threads it
registered, so an installed checker never perturbs unrelated threads.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Optional

__all__ = ["SyncHook", "sync_point", "observe", "set_sync_hook",
           "installed"]


class SyncHook:
    """Base hook: subclass and override either/both methods."""

    def sync(self, name: str, obj: Any = None) -> None:
        """A schedulable point; may block the calling thread."""

    def observe(self, name: str, obj: Any = None) -> None:
        """A bookkeeping event; must return promptly and never block."""


_HOOK: Optional[SyncHook] = None


def sync_point(name: str, obj: Any = None) -> None:
    """Mark a schedulable synchronization point (see module docstring)."""
    h = _HOOK
    if h is not None:
        h.sync(name, obj)


def observe(name: str, obj: Any = None) -> None:
    """Record a non-parking bookkeeping event for invariant checking."""
    h = _HOOK
    if h is not None:
        h.observe(name, obj)


def set_sync_hook(hook: Optional[SyncHook]) -> Optional[SyncHook]:
    """Install `hook` (None to uninstall); returns the previous hook."""
    global _HOOK
    prev, _HOOK = _HOOK, hook
    return prev


@contextmanager
def installed(hook: SyncHook):
    """`with installed(hook):` — scoped installation, restores on exit."""
    prev = set_sync_hook(hook)
    try:
        yield hook
    finally:
        set_sync_hook(prev)
