"""Exact DTW search under a Sakoe-Chiba band: LB_Keogh, the refinement
of a search, and the brute-force scan.

On CUDA tensors `lb_keogh`, `dtw_search` and `dtw_scan` launch the
kernels of `csrc/dtw.cu` (a port-side source with no Pallas original:
repro's DTW is plain jnp), by the routes `lb_route` and `dp_route` pick
from the shapes, or by the general route where the caller asks; on CPU tensors they run the plain versions
`ref.lb_keogh_ref`, `ref.dtw_search_ref` and `ref.dtw_scan_ref`.  On any
other device they raise.  `launches` counts the kernels' launches,
`by_route` those of each (kernel, route).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .ref import dtw_scan_ref, dtw_search_ref, lb_keogh_ref

launches = 0
by_route: dict = {}                    # launches of each "kernel/route"

MAX_L = 1024                           # the longest series a kernel takes
MAX_BAND_R = 16                        # the band route's largest radius
GROUP = 32                             # queries of one lb_keogh launch
_SMEM = 200 * 1024                     # shared memory a block may ask for
_SCAN_THREADS = {"band": 128, "general": 64}

_LB_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
_SEARCH_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                    + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 7)
_SCAN_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                  + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
_DP_CODES = {"band": 0, "general": 1}


def lb_route(L: int) -> str:
    """"l256" for 224 < L <= 256 (a lane holds 8 values of each of 4
    series a warp takes at once), "general" for every other L <= 1024."""
    return "l256" if 224 < L <= 256 else "general"


def dp_route(r: int) -> str:
    """"band" for r <= 16 (the previous row's band in registers, one
    template instance a radius), "general" for r > 16 (in shared
    memory)."""
    return "band" if r <= MAX_BAND_R else "general"


def _pick(route, default: str, allowed: tuple, what: str) -> str:
    """The route a caller asked for (None: the default), if it takes the
    shape."""
    if route is None:
        return default
    if route not in allowed:
        raise ValueError(f"{what} takes the routes {allowed}, got {route!r}")
    return route


def lb_group(L: int) -> int:
    """Queries one lb_keogh launch takes: at most 32 (a lane keeps one
    query's sum), and their envelopes must fit in shared memory."""
    return max(1, min(GROUP, _SMEM // (8 * L)))


def _count(kernel: str, route: str) -> None:
    global launches
    with _build.COUNT_LOCK:
        launches += 1
        key = f"{kernel}/{route}"
        by_route[key] = by_route.get(key, 0) + 1


def _check(q: torch.Tensor, x: torch.Tensor, r: int) -> None:
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"need q (Q, L) and x (N, L), got "
                         f"{tuple(q.shape)} and {tuple(x.shape)}")
    if q.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"q and x must be float32, got {q.dtype}, {x.dtype}")
    if not (q.is_contiguous() and x.is_contiguous()):
        raise ValueError("q and x must be contiguous")
    if q.device != x.device:
        raise ValueError("q and x must share a device")
    if not 1 <= q.shape[1] <= MAX_L:
        raise ValueError(f"series length must be in [1, {MAX_L}], got "
                         f"{q.shape[1]}")
    if not isinstance(r, int) or r < 0:
        raise ValueError(f"band radius r must be an int >= 0, got {r!r}")
    if q.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no DTW kernel for device {q.device}")


def lb_keogh(q: torch.Tensor, x: torch.Tensor, *, r: int,
             route: str | None = None) -> torch.Tensor:
    """The squared LB_Keogh of each query of q (Qg, L) against each series
    of x (N, L), band radius r: (Qg, N) float32.  One launch for each
    `lb_group(L)` queries, each reading the collection once, by `route`
    (default `lb_route(L)`; "general" takes every L).

    Raises ValueError/TypeError on input the kernel does not take, and
    RuntimeError if a launch fails."""
    _check(q, x, r)
    L = q.shape[1]
    route = _pick(route, lb_route(L), (lb_route(L), "general"), "lb_keogh")
    if q.device.type == "cpu":
        return lb_keogh_ref(q, x, r)
    Qg, N = q.shape[0], x.shape[0]
    out = torch.empty((Qg, N), dtype=torch.float32, device=x.device)
    fn = _build.entry("dtw", "dtw_lb_keogh", _LB_ARGTYPES)
    step = lb_group(L)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for g0 in range(0, Qg, step):
            n = min(step, Qg - g0)
            code = fn(q[g0:].data_ptr(), x.data_ptr(), N, L, n, r,
                      0 if route == "l256" else 1, out[g0:].data_ptr(),
                      stream)
            _build.check("dtw", "dtw_lb_keogh", code)
            _count("lb_keogh", route)
    return out


def dtw_search(q: torch.Tensor, x: torch.Tensor, sorted_lb: torch.Tensor,
               order: torch.Tensor, *, r: int, round_k: int,
               route: str | None = None) -> Tuple[torch.Tensor, ...]:
    """The refinement of a DTW 1-NN search for each query of q (Qg, L)
    over x (N, L), in one launch: candidates order (Qg, N) int64 in the
    order of their ascending bounds sorted_lb (Qg, N) float32, round_k
    (<= 1024) a round, the loop of rounds on the device, by `route`
    (default `dp_route(r)`; "general" takes every r).  Returns (bsf
    (Qg,) float32 squared distances, best (Qg,) int32 ids, -1 where no
    candidate was taken, rounds (Qg,) int32, refined (Qg,) int32: the
    candidates whose DTW was computed), as `ref.dtw_search_ref`.

    Raises ValueError/TypeError on input the kernel does not take, and
    RuntimeError if the launch fails."""
    _check(q, x, r)
    Qg, L = q.shape
    N = x.shape[0]
    if sorted_lb.shape != (Qg, N) or order.shape != (Qg, N):
        raise ValueError(f"sorted_lb and order must be ({Qg}, {N}), got "
                         f"{tuple(sorted_lb.shape)}, {tuple(order.shape)}")
    if sorted_lb.dtype != torch.float32 or order.dtype != torch.int64:
        raise TypeError(f"need sorted_lb float32 and order int64, got "
                        f"{sorted_lb.dtype}, {order.dtype}")
    if not (sorted_lb.is_contiguous() and order.is_contiguous()):
        raise ValueError("sorted_lb and order must be contiguous")
    if sorted_lb.device != x.device or order.device != x.device:
        raise ValueError("sorted_lb and order must be on x's device")
    if not isinstance(round_k, int) or not 1 <= round_k <= 1024:
        raise ValueError(f"round_k must be in [1, 1024], got {round_k!r}")
    threads = -(-round_k // 32) * 32
    route = _pick(route, dp_route(r), (dp_route(r), "general"),
                  "dtw_search")
    if route == "general" and 4 * (L + (2 * r + 1) * threads) > _SMEM:
        raise ValueError(f"band radius {r} with round_k {round_k} needs "
                         f"more shared memory than a block has")
    if q.device.type == "cpu":
        return dtw_search_ref(q, x, sorted_lb, order, r, round_k)
    dev = x.device
    bsf = torch.empty((Qg,), dtype=torch.float32, device=dev)
    best, rounds, refined = (torch.empty((Qg,), dtype=torch.int32,
                                         device=dev) for _ in range(3))
    if Qg == 0:
        return bsf, best, rounds, refined
    fn = _build.entry("dtw", "dtw_search", _SEARCH_ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(q.data_ptr(), x.data_ptr(), N, L, r, Qg, round_k, threads,
                  _DP_CODES[route], sorted_lb.data_ptr(), order.data_ptr(),
                  bsf.data_ptr(), best.data_ptr(), rounds.data_ptr(),
                  refined.data_ptr(),
                  torch.cuda.current_stream(dev).cuda_stream)
    _build.check("dtw", "dtw_search", code)
    _count("dtw_search", route)
    return bsf, best, rounds, refined


def dtw_scan(q: torch.Tensor, x: torch.Tensor, *, r: int,
             route: str | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Banded DTW of each query of q (Q, L) against every series of x
    (N >= 1, L), in one launch: (the least squared distance (Q,)
    float32, its series (Q,) int32, the first on ties), by `route` as
    `dtw_search`'s.

    Raises ValueError/TypeError on input the kernel does not take, and
    RuntimeError if the launch fails."""
    _check(q, x, r)
    Q, L = q.shape
    N = x.shape[0]
    if N == 0:
        raise ValueError("dtw_scan needs at least one series")
    if N >= 1 << 31 or Q > 65535:
        raise ValueError(f"dtw_scan takes N < 2^31 and Q <= 65535, got "
                         f"{N}, {Q}")
    route = _pick(route, dp_route(r), (dp_route(r), "general"), "dtw_scan")
    if (route == "general"
            and 4 * (L + (2 * r + 1) * _SCAN_THREADS[route]) > _SMEM):
        raise ValueError(f"band radius {r} needs more shared memory than "
                         f"a block has")
    if q.device.type == "cpu":
        return dtw_scan_ref(q, x, r)
    dev = x.device
    # all ones: above every (distance bits << 32 | series) key
    keys = torch.full((Q,), -1, dtype=torch.int64, device=dev)
    if Q:
        fn = _build.entry("dtw", "dtw_scan", _SCAN_ARGTYPES)
        with torch.cuda.device(dev):
            code = fn(q.data_ptr(), x.data_ptr(), N, L, r, Q,
                      _DP_CODES[route], keys.data_ptr(),
                      torch.cuda.current_stream(dev).cuda_stream)
        _build.check("dtw", "dtw_scan", code)
        _count("dtw_scan", route)
    d2 = (keys >> 32).to(torch.int32).view(torch.float32)
    return d2, (keys & 0xFFFFFFFF).to(torch.int32)
