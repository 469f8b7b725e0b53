"""The materialize pass of the index builder: rows gathered into leaf order.

On CUDA tensors a `launcher`'s launches run the kernel `leaf_gather` of
`csrc/leaf_stats.cu`, once for each range of sorted rows, writing each
row's series (in the storage type), PAA, symbols, squared norm and id
through the sort order; on CPU tensors they run the plain version
`ref.leaf_gather_ref` (five torch gathers).  A copy is exact, so both
give the same bits.  `launches` counts the kernel's launches, `by_route`
those of each copy width (`route`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .ref import leaf_gather_ref

launches = 0
by_route: dict = {}                    # launches of each copy width

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
             + [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 6)
_DTYPES = (torch.float32, torch.float16, torch.bfloat16)


def route(row_bytes: int, *bases: int) -> str:
    """The copy width of a series row of `row_bytes` bytes between the
    given base addresses: "u16", "u8", "u4" or "u2", the widest of 16,
    8, 4 and 2 bytes that divides the row and every base."""
    for u in (16, 8, 4):
        if row_bytes % u == 0 and all(b % u == 0 for b in bases):
            return f"u{u}"
    return "u2"


def _check(order, src, out, perm_src):
    series, paa, words, sqn = src
    o_series, o_paa, o_words, o_sqn, o_perm = out
    N, P = series.shape[0], o_series.shape[0]
    ok = (order.dim() == 1 and order.dtype == torch.int64
          and series.dim() == 2 and series.dtype in _DTYPES
          and o_series.shape[1:] == series.shape[1:]
          and o_series.dtype == series.dtype
          and paa.dim() == 2 and paa.shape[0] == N
          and paa.dtype == torch.float32 and o_paa.dtype == torch.float32
          and o_paa.shape == (P, paa.shape[1])
          and words.shape == paa.shape and words.dtype == torch.uint8
          and o_words.shape == o_paa.shape and o_words.dtype == torch.uint8
          and sqn.shape == (N,) and sqn.dtype == torch.float32
          and o_sqn.shape == (P,) and o_sqn.dtype == torch.float32
          and o_perm.shape == (P,) and o_perm.dtype == torch.int32
          and (perm_src is None or (perm_src.shape == (N,)
                                    and perm_src.dtype == torch.int32)))
    if not ok:
        raise ValueError(
            "need order (n,) int64, src (series (N, L) float32/16 or "
            "bfloat16, paa (N, w) float32, words (N, w) uint8, sq_norms (N,) "
            "float32), out the same of P rows plus perm (P,) int32, and "
            "perm_src (N,) int32 or None")
    ts = (order, *src, *out) + (() if perm_src is None else (perm_src,))
    if any(t.device != order.device or not t.is_contiguous() for t in ts):
        raise ValueError("leaf_gather takes contiguous tensors on one device")


def launcher(order: torch.Tensor, src, out,
             perm_src: Optional[torch.Tensor] = None):
    """Check the inputs once and return launch(r0, r1), which writes
    sorted rows [r0, r1) of out = (series, paa, words, sq_norms, perm),
    each taking source row order[r] of src = (series, paa, words,
    sq_norms); perm[r] = perm_src[order[r]], or order[r] where perm_src
    is None.  For a caller that launches ranges of one set of tensors,
    the index builder's parts.  On the card every launch goes to the
    stream that is current where the launcher is made.

    Raises ValueError on input the kernel does not take, and
    RuntimeError if there is no kernel for the device or a launch fails;
    launch raises ValueError for a range that is not 0 <= r0 <= r1 <=
    min(len(order), len(out[0])).  order is not checked against N.
    """
    _check(order, src, out, perm_src)
    dev = order.device
    cap = min(order.shape[0], out[0].shape[0])

    def in_range(r0, r1):
        if not 0 <= r0 <= r1 <= cap:
            raise ValueError(f"need 0 <= r0 <= r1 <= {cap}, got rows {r0}, "
                             f"{r1}")
        return r1 > r0

    if dev.type == "cpu":
        def launch(r0: int, r1: int) -> None:
            if in_range(r0, r1):
                leaf_gather_ref(order, src, out, (r0, r1), perm_src)
        return launch
    if dev.type != "cuda":
        raise RuntimeError(f"no leaf_gather kernel for device {dev}")
    series = src[0]
    row_bytes = series.shape[1] * series.element_size()
    how = route(row_bytes, series.data_ptr(), out[0].data_ptr())
    fn = _build.entry("leaf_stats", "leaf_gather", _ARGTYPES)
    args = (series.data_ptr(), row_bytes, int(how[1:]),
            *(t.data_ptr() for t in src[1:]),
            None if perm_src is None else perm_src.data_ptr(),
            src[1].shape[1], *(t.data_ptr() for t in out),
            torch.cuda.current_stream(dev).cuda_stream)
    order_ptr = order.data_ptr()

    def launch(r0: int, r1: int) -> None:
        global launches
        if not in_range(r0, r1):
            return
        with torch.cuda.device(dev):
            code = fn(order_ptr, r0, r1 - r0, *args)
        _build.check("leaf_stats", "leaf_gather", code)
        with _build.COUNT_LOCK:
            launches += 1
            by_route[how] = by_route.get(how, 0) + 1
    return launch
