"""The flat index and its search, on torch tensors.

The package answers every name `repro.core` exports, each imported from
its module at first use (the search imports the kernels, which import
`core.isax`, so an eager import would cycle).  A name that is also a
submodule stays the submodule: `core.isax`, and `core.search`, where
`repro.core.search` is the deprecated function (the port's is
`core.search.search`)."""

from repro_torch import _exports

_NAMES = {
    "builder": ("IndexBuilder", "merge_sorted_delta"),
    "dtw": ("lb_keogh", "dtw_band", "search_dtw"),
    "index": ("FlatIndex", "build_index", "build_index_host", "index_stats",
              "leaf_stats_blocks", "pad_leaves"),
    "refresh": ("CounterObject", "Injectors", "RefreshExecutor",
                "RefreshRun", "WorkerCrash"),
    "search": ("build_sharded_plan", "build_sharded_search",
               "make_sharded_search", "merge_delta_topk", "prepare_queries",
               "run_search", "search_bruteforce", "search_plan",
               "shard_index", "snapshot_search"),
    "traverse": ("ArrayTraverse", "Executor", "SequentialExecutor",
                 "StageStats", "TraverseObject", "check_traversing_property",
                 "traverse_complete"),
}
__getattr__, __dir__ = _exports(__name__, _NAMES)
