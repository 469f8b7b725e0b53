"""Concurrency correctness tooling of the port: the SyncHook seam
(`hooks`) and a schedule-exploring race checker over the port's own
machinery (`schedules` + `checker`, `python -m repro_torch.analysis.
checker`; seeded bugs in `buggy`).  The port's counterpart of
`repro.analysis`, less its AST lint, which reads source files and
already covers `src/repro_torch/`.

This package root stays import-light: `hooks` is imported by
`core.refresh`, `runtime.journal`, `serve.engine` and `serve.plan_cache`
on their hot paths.
"""

from .hooks import SyncHook, observe, set_sync_hook, sync_point  # noqa: F401

__all__ = ["SyncHook", "observe", "set_sync_hook", "sync_point"]
