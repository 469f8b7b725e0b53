"""The CUDA kernels of the port and their plain PyTorch versions.

    isax_summarize  — z-norm + PAA + iSAX quantization (build)
    lb_distance     — batched MINDIST over leaf regions (pruning)
    ed_argmin       — exact 1-NN scan, min/argmin in matmul form
    refine          — one refinement round: gather + distances + top-k fold
    refine_search   — every refinement round of a search in one launch,
                      exact or under the (1 + eps) stop
    flash_attention — causal / sliding-window GQA attention
    leaf_stats      — per-leaf regions of the key-sorted rows (build)
    leaf_gather     — rows gathered into leaf order (the builder)

Each wrapper module picks its kernel's route from the shapes (`route`),
launches it on CUDA tensors and counts the launches in `launches`.
ops.py holds the entry points (as repro.kernels.ops does) and
`ops.WRAPPERS`, each entry point's wrapper module; ref.py the plain
versions; autotune.py the search-knob sweep and its table.  Nothing is re-exported here, so `kernels.lb_distance` is
always the wrapper module.
"""
