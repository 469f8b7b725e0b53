"""Serving layer of the port: micro-batching, captured search plans,
snapshot-consistent concurrent writes, for a local or a sharded index.

    from repro_torch.api import FreshIndex
    from repro_torch.serve import EngineConfig

    index = FreshIndex.build(series)          # on "cuda"
    with index.engine(EngineConfig(max_batch=32, workers=1)) as engine:
        engine.warmup(ks=(1, 10))          # one CUDA graph per bucket
        fut = engine.submit(q, k=10)       # returns immediately
        dist, ids = fut.result()           # == index.search(q, k=10)
        engine.add(batch)                  # new epoch; in-flight queries
                                           # keep their snapshot
        print(engine.stats())              # p50/p99, epoch lag, hit rate

Module map: `engine` (QueryEngine/futures/epoch snapshots), `batcher`
(shape-bucketed padding), `plan_cache` (one captured CUDA graph per
(bucket, k, knobs, epoch); for a sharded index a `ShardedCompiledPlan`,
run eagerly), `result_cache` (epoch-keyed LRU over delivered rows).  The
compute itself is `repro_torch.core.search.view_search_device` (for a
sharded index `sharded_view_search`), the function `FreshIndex.search`
runs.

Overload behavior is opt-in and typed: `EngineConfig.max_pending`
bounds admission (AdmissionError, batch priority shed first),
`submit(deadline_ms=...)` bounds queueing (DeadlineExceeded), and
`result(timeout=...)` raises ResultTimeout while leaving the future
completable.  Lifecycle writes (`delete`, `update`, `add(ttl_s=...)`)
publish epochs like adds, and `EngineConfig.maintenance` schedules TTL
sweeps, compactions and checkpoints as journal-registered work.
`EngineConfig.latency_tiers` maps a priority class to "exact" or a
calibrated recall target.  A sharded index (`index.shard(mesh)`) gets
mesh-wide epochs and `recover(checkpoint, mesh=...)`.  The counterpart
of `repro.serve`.
"""

from .batcher import (Batch, MicroBatcher, Pending, bucket_for,
                      earliest_deadline, shape_buckets)
from .engine import (AdmissionError, DeadlineExceeded, EngineConfig,
                     QueryEngine, ResultTimeout, SearchFuture, Snapshot)
from .plan_cache import (CompiledPlan, Knobs, PlanCache,
                         ShardedCompiledPlan, plan_key)
from .result_cache import ResultCache, query_fingerprint

__all__ = [
    "Batch", "MicroBatcher", "Pending", "bucket_for",
    "earliest_deadline", "shape_buckets",
    "AdmissionError", "DeadlineExceeded", "EngineConfig", "QueryEngine",
    "ResultTimeout", "SearchFuture", "Snapshot",
    "CompiledPlan", "Knobs", "PlanCache", "ShardedCompiledPlan",
    "plan_key",
    "ResultCache", "query_fingerprint",
]
