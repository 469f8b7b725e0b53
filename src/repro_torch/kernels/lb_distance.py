"""Batched lower-bound (MINDIST) distances, the pruning stage.

On CUDA tensors `lb_distance` launches the kernel of
`csrc/lb_distance.cu`, by the route `route` picks from w; on CPU tensors
it runs the plain version `ref.lb_distance_ref`.  `launches` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import isax

from . import _build
from .ref import lb_distance_ref
from .refine import aligned

launches = 0
by_route: dict = {}                    # launches of each route

_ROUTES = ("tiled", "looped")
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def route(w: int) -> str:
    """The kernel route for w segments: "tiled" (the tile staged in
    shared memory, 32 queries by 4 leaves a thread) for w in {4, 8, 16},
    "looped" (w a runtime loop) for any other w."""
    return "tiled" if w in (4, 8, 16) else "looped"


def lb_distance(q_paa: torch.Tensor, leaf_lo: torch.Tensor,
                leaf_hi: torch.Tensor, *,
                series_len: int = isax.SERIES_LEN) -> torch.Tensor:
    """(Q, w) x (NL, w) x (NL, w) float32 -> (Q, NL) squared lower bounds,
    any Q (the grid's y dimension takes 65,535 query tiles a launch: more
    go in more launches, each on its slice of the queries).

    Raises ValueError/TypeError on input the kernel does not take, and
    RuntimeError if a launch fails.
    """
    global launches
    if q_paa.dim() != 2 or leaf_lo.dim() != 2 or \
            leaf_lo.shape != leaf_hi.shape or \
            q_paa.shape[1] != leaf_lo.shape[1]:
        raise ValueError(f"need q_paa (Q, w) and leaf_lo/hi (NL, w), got "
                         f"{tuple(q_paa.shape)}, {tuple(leaf_lo.shape)}, "
                         f"{tuple(leaf_hi.shape)}")
    for t in (q_paa, leaf_lo, leaf_hi):
        if t.dtype != torch.float32:
            raise TypeError(f"lb_distance takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("lb_distance takes contiguous tensors")
        if t.device != q_paa.device:
            raise ValueError("q_paa and leaf_lo/hi must share a device")
    if q_paa.device.type == "cpu":
        return lb_distance_ref(q_paa, leaf_lo, leaf_hi, series_len)
    if q_paa.device.type != "cuda":
        raise RuntimeError(f"no lb_distance kernel for device "
                           f"{q_paa.device}")
    Q, w = q_paa.shape
    how = route(w)
    NL = leaf_lo.shape[0]
    # the tiled route reads whole 16-byte pieces of each row
    q_paa, leaf_lo, leaf_hi = (aligned(t) for t in (q_paa, leaf_lo, leaf_hi))
    out = torch.empty((Q, NL), dtype=torch.float32, device=q_paa.device)
    if Q == 0 or NL == 0:
        return out
    fn = _build.entry("lb_distance", "lb_distance", _ARGTYPES)
    with torch.cuda.device(q_paa.device):
        code = fn(q_paa.data_ptr(), leaf_lo.data_ptr(), leaf_hi.data_ptr(),
                  out.data_ptr(), Q, NL, w, float(series_len) / w,
                  _ROUTES.index(how),
                  torch.cuda.current_stream().cuda_stream)
    _build.check("lb_distance", "lb_distance", code)
    launches += 1
    by_route[how] = by_route.get(how, 0) + 1
    return out
