"""The kernel entry points: the counterpart of `repro.kernels.ops`.

The same five names with the same defaults, taken from `core/isax.py`.
Each runs its CUDA kernel on CUDA tensors and its plain version on CPU
tensors (see the wrapper modules).  repro's TPU-only knobs are left out:
`interpret` (the Pallas interpreter; here the CPU path is the plain
version), refine's `lowering`, `dma_depth` and `block_q` (which choose
among Mosaic/Triton structures of one function; the port has one CUDA
kernel), and attention's `block_q` (repro's query tiling, which changes
no result; the CUDA kernel masks a ragged T, so any T >= 1 is taken).

`WRAPPERS` maps each entry point to its wrapper module, whose `launches`
counts its kernel's launches, and "refine_search" (the whole refinement
of a search, which the search calls in place of a loop of refine_topk
rounds), "leaf_stats" and "leaf_gather" (the build's per-leaf passes,
which have no entry point in repro) and "dtw" (LB_Keogh, the DTW
search's refinement and the DTW scan, which `core/dtw.py` calls: repro's
DTW is plain jnp) to their own wrapper modules.
"""

from __future__ import annotations

from importlib import import_module

from repro_torch.core import isax

from .ed_argmin import ed_argmin as _ed_argmin
from .flash_attention import flash_attention as _flash_attention
from .isax_summarize import summarize as _summarize
from .lb_distance import lb_distance as _lb_distance
from .refine import refine_topk as _refine_topk

WRAPPERS = {name: import_module(f"{__package__}.{mod}") for name, mod in (
    ("summarize", "isax_summarize"), ("lb_distance", "lb_distance"),
    ("ed_argmin", "ed_argmin"), ("refine_topk", "refine"),
    ("refine_search", "refine_search"),
    ("flash_attention", "flash_attention"),
    ("leaf_stats", "leaf_stats"), ("leaf_gather", "leaf_gather"),
    ("dtw", "dtw"))}


def summarize(x, *, segments=None, bits=None, znorm=True):
    return _summarize(
        x, segments=isax.SEGMENTS if segments is None else segments,
        bits=isax.SAX_BITS if bits is None else bits, znorm=znorm)


def lb_distance(q_paa, leaf_lo, leaf_hi, *, series_len=None):
    return _lb_distance(
        q_paa, leaf_lo, leaf_hi,
        series_len=isax.SERIES_LEN if series_len is None else series_len)


def ed_argmin(q, xs):
    return _ed_argmin(q, xs)


def refine_topk(q, q_sq, series, sq_norms, leaf_ids, alive, bsf_d, bsf_e,
                *, leaf_capacity, k):
    return _refine_topk(q, q_sq, series, sq_norms, leaf_ids, alive, bsf_d,
                        bsf_e, leaf_capacity=leaf_capacity, k=k)


def flash_attention(q, k, v, *, causal=True, window=0):
    return _flash_attention(q, k, v, causal=causal, window=window)
