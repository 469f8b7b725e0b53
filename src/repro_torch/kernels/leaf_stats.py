"""Per-leaf regions of the key-sorted rows: the build's leaf_stats pass.

On CUDA tensors `leaf_stats` (all leaves) and a `launcher`'s launches (a
range of leaves each) run the kernel `leaf_stats` of
`csrc/leaf_stats.cu`, which reads the rows through the sort order; on
CPU tensors they run the plain version `ref.leaf_stats_ref`
(`leaf_stats_blocks` over the gathered rows).  `build_index` calls the
first, the index builder's leaf_stats phase launches a range of leaves a
part, and min, max and a table lookup are exact, so the two give the
same bits.  `launches` counts the
kernel's launches, `by_route` those of each bound's instance.
"""

from __future__ import annotations

import ctypes
import torch

from repro_torch.core import isax

from . import _build
from .ref import leaf_stats_ref

launches = 0
by_route: dict = {}                    # launches of each bound's instance

BOUNDS = ("prefix", "symbox", "paabox")
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 4
             + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 5)


def _check(paa, words, order, n, M, bits, bound, out):
    if paa.dim() != 2 or words.shape != paa.shape or order.dim() != 1:
        raise ValueError(f"need paa and words (N, w) and order (n,), got "
                         f"{tuple(paa.shape)}, {tuple(words.shape)}, "
                         f"{tuple(order.shape)}")
    if (paa.dtype != torch.float32 or words.dtype != torch.uint8
            or order.dtype != torch.int64):
        raise TypeError(f"need paa float32, words uint8 and order int64, "
                        f"got {paa.dtype}, {words.dtype}, {order.dtype}")
    if not (paa.is_contiguous() and words.is_contiguous()
            and order.is_contiguous()):
        raise ValueError("leaf_stats takes contiguous tensors")
    if words.device != paa.device or order.device != paa.device:
        raise ValueError("paa, words and order must share a device")
    if not 0 <= n <= order.shape[0] or M < 1 or not 1 <= bits <= 8:
        raise ValueError(f"need 0 <= n <= len(order), leaf_capacity >= 1 "
                         f"and 1 <= bits <= 8, got {n}, {M}, {bits}")
    if bound not in BOUNDS:
        raise ValueError(f"unknown bound {bound!r}")
    w = paa.shape[1]
    lo, hi, valid = out
    if (lo.shape != hi.shape or lo.dim() != 2 or lo.shape[1] != w
            or valid.shape != lo.shape[:1] or lo.dtype != torch.float32
            or hi.dtype != torch.float32 or valid.dtype != torch.bool
            or any(o.device != paa.device or not o.is_contiguous()
                   for o in out)):
        raise ValueError(f"out must be contiguous (leaf_lo, leaf_hi, "
                         f"leaf_valid) of shapes (g, {w}), (g, {w}), (g,), "
                         f"float32, float32, bool, on paa's device")


def launcher(paa: torch.Tensor, words: torch.Tensor, order: torch.Tensor,
             n: int, *, leaf_capacity: int, bits: int, bound: str, out):
    """Check the inputs once and return launch(l0, l1), which writes the
    regions of leaves [l0, l1) (a leaf past the rows gets the empty region
    [+inf, +inf] and leaf_valid False) into rows l0..l1 of `out` =
    (leaf_lo, leaf_hi, leaf_valid), three tensors of g >= l1 leaves: for
    a caller that launches ranges of one set of tensors, the index
    builder's parts.  On the card every launch goes to the stream that is
    current where the launcher is made.

    Raises as `leaf_stats`; launch raises ValueError for a range that is
    not 0 <= l0 <= l1 <= g.
    """
    M = leaf_capacity
    _check(paa, words, order, n, M, bits, bound, out)
    dev, cap = paa.device, out[0].shape[0]

    def in_range(l0, l1):
        if not 0 <= l0 <= l1 <= cap:
            raise ValueError(f"need 0 <= l0 <= l1 <= {cap}, got leaves "
                             f"{l0}, {l1}")
        return l1 > l0

    if dev.type == "cpu":
        def launch(l0: int, l1: int) -> None:
            if in_range(l0, l1):
                res = leaf_stats_ref(paa, words, order, n, M, bits, bound,
                                     (l0, l1))
                for o, r in zip(out, res):
                    o[l0:l1] = r
        return launch
    if dev.type != "cuda":
        raise RuntimeError(f"no leaf_stats kernel for device {dev}")
    w = paa.shape[1]
    pad = isax.table("padded_breakpoints", bits, torch.float32, dev)
    fn = _build.entry("leaf_stats", "leaf_stats", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lo, hi, valid = (o.data_ptr() for o in out)
    head = (paa.data_ptr(), words.data_ptr(), order.data_ptr(), n, w, M, bits,
            BOUNDS.index(bound))

    def launch(l0: int, l1: int) -> None:
        global launches
        if not in_range(l0, l1):
            return
        with torch.cuda.device(dev):
            code = fn(*head, l0, l1 - l0, pad.data_ptr(), lo + 4 * l0 * w,
                      hi + 4 * l0 * w, valid + l0, stream)
        _build.check("leaf_stats", "leaf_stats", code)
        with _build.COUNT_LOCK:
            launches += 1
            by_route[bound] = by_route.get(bound, 0) + 1
    return launch


def leaf_stats(paa: torch.Tensor, words: torch.Tensor, order: torch.Tensor,
               n: int, *, leaf_capacity: int, bits: int, bound: str):
    """The regions of the ceil(n / leaf_capacity) leaves of the key-sorted
    rows, in one launch.

    Sorted row r < n is source row order[r] of paa (N, w) float32 and
    words (N, w) uint8; leaf l holds sorted rows [l * M, (l + 1) * M);
    rows >= n are padding.  Returns (leaf_lo, leaf_hi (g, w) float32,
    leaf_valid (g,) bool), as `leaf_stats_blocks` gives them.

    Raises ValueError/TypeError on input the kernel does not take, and
    RuntimeError if a launch fails.  order is not checked against N.
    """
    g = -(-n // max(leaf_capacity, 1))
    out = (paa.new_empty((g, paa.shape[-1])),
           paa.new_empty((g, paa.shape[-1])),
           paa.new_empty((g,), dtype=torch.bool))
    launcher(paa, words, order, n, leaf_capacity=leaf_capacity, bits=bits,
             bound=bound, out=out)(0, g)
    return out
