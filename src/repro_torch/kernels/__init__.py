"""The CUDA kernels of the port and their plain PyTorch versions.

    isax_summarize  — z-norm + PAA + iSAX quantization (build)
    lb_distance     — batched MINDIST over leaf regions (pruning)
    ed_argmin       — exact 1-NN scan, min/argmin in matmul form
    refine          — one refinement round: gather + distances + top-k fold
    refine_search   — every refinement round of a search in one launch
    flash_attention — causal / sliding-window GQA attention

ops.py holds the entry points (as repro.kernels.ops does), re-exported
here; ref.py the plain versions.  The re-exported functions shadow the
wrapper modules of the same name, as in repro: reach a wrapper module
(and its `launches`) through `ops.WRAPPERS` or by its full name.
"""

from . import ops, ref  # noqa: F401
from .ops import (ed_argmin, flash_attention, lb_distance,  # noqa: F401
                  refine_topk, summarize)
