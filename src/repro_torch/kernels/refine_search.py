"""Every refinement round of a search in one launch.

`refine_search` runs each query's rounds until its own stop, which gives
the buffer of repro's global loop of `refine_topk` rounds.  On CUDA
tensors it launches the `refine_search` kernel of `csrc/refine.cu`
(thread-block clusters of 8 CTAs a query, cut to a divisor of K, taking
the queries heaviest first); on CPU tensors it runs the plain version
`ref.refine_search_ref`.  `launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .ref import refine_search_ref
from .refine import _DTYPES, _check_tensors, _dims

launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 9
             + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def _check(q, q_sq, series, sq_norms, order, sorted_lb, M: int, k: int,
           K: int, alive_out) -> None:
    Q, L = _dims(q, series, M, k, K)
    if order.dim() != 2 or order.shape[1] % K:
        raise ValueError(f"order must be (Q, rounds * {K}), got "
                         f"{tuple(order.shape)}")
    R = order.shape[1]
    want = {"q_sq": (q_sq, (Q,), torch.float32),
            "sq_norms": (sq_norms, (series.shape[0],), torch.float32),
            "order": (order, (Q, R), torch.int32),
            "sorted_lb": (sorted_lb, (Q, R), torch.float32),
            "q": (q, (Q, L), torch.float32)}
    if alive_out is not None:
        want["alive_out"] = (alive_out, (Q,), torch.int32)
    _check_tensors("refine_search", q, series, want)


def estimated_work(q, q_sq, series, sq_norms, order, sorted_lb, M: int,
                   k: int, K: int) -> torch.Tensor:
    """Each query's leaves whose lower bound lies below its k-th best
    distance after the first round (the members of its first K leaves),
    as (Q,) int64.

    The k-th best only falls, so every slot alive after the first round
    is one of these leaves: a cheap overestimate of the query's work (K
    leaves a query, where the search reads thousands), and each query's
    alive slots are at most this plus K.
    """
    Q = q.shape[0]
    if order.shape[1] == 0 or k > K * M:
        return torch.full((Q,), order.shape[1], dtype=torch.int64,
                          device=q.device)
    rows = (order[:, :K].long()[..., None] * M
            + torch.arange(M, device=q.device)).reshape(Q, K * M)
    dots = torch.einsum("qnl,ql->qn", series[rows].float(), q)
    d2 = (q_sq[:, None] + sq_norms[rows] - 2.0 * dots).clamp_min(0.0)
    kth = d2.kthvalue(k, dim=1).values.contiguous()
    return torch.searchsorted(sorted_lb, kth[:, None])[:, 0]


def refine_search(q: torch.Tensor, q_sq: torch.Tensor, series: torch.Tensor,
                  sq_norms: torch.Tensor, order: torch.Tensor,
                  sorted_lb: torch.Tensor, *, leaf_capacity: int, k: int,
                  round_leaves: int,
                  alive_out: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every refinement round of a search, from the empty buffer.

    q, q_sq, series, sq_norms as for `refine.refine_topk`;
    order:     (Q, cap * K) int32 leaf ids of each query's priority queue,
               ascending in lower bound (each a leaf of `series`)
    sorted_lb: (Q, cap * K) f32 their lower bounds, padding at BIG
    alive_out: optional (Q,) int32, receives each query's alive slots;
               they are the first that many entries of its queue, since
               the queue ascends and the k-th best never grows
    -> (bsf_d, bsf_e, rounds): the (Q, k) buffer and the (Q,) int32
       rounds each query ran, as `ref.refine_search_ref` returns them.
       Raises ValueError/TypeError on input the kernel does not take,
       and RuntimeError if a launch fails.
    """
    global launches
    M, K = leaf_capacity, round_leaves
    _check(q, q_sq, series, sq_norms, order, sorted_lb, M, k, K, alive_out)
    if q.device.type == "cpu":
        return refine_search_ref(q, q_sq, series, sq_norms, order, sorted_lb,
                                 leaf_capacity=M, k=k, round_leaves=K,
                                 alive_out=alive_out)
    if q.device.type != "cuda":
        raise RuntimeError(f"no refine_search kernel for device {q.device}")
    Q, L = q.shape
    per16 = 16 // series.element_size()
    if (L % per16 or series.data_ptr() % 16 or q.data_ptr() % 16
            or sq_norms.data_ptr() % 16):
        raise ValueError(f"the refine_search kernel copies rows in 16-byte "
                         f"pieces: L={L} must be a multiple of {per16} and "
                         f"series, sq_norms and q 16-byte aligned")
    if sq_norms.shape[0] % 4:
        # the kernel copies a leaf's norms as a 16-byte aligned window,
        # which must not run past the end
        sq_norms = torch.nn.functional.pad(sq_norms,
                                           (0, 4 - sq_norms.shape[0] % 4))
    dev = q.device
    out_d = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_e = torch.empty((Q, k), dtype=torch.int32, device=dev)
    rounds = torch.empty((Q,), dtype=torch.int32, device=dev)
    alive = (torch.empty((Q,), dtype=torch.int32, device=dev)
             if alive_out is None else alive_out)
    if Q == 0:
        return out_d, out_e, rounds
    counter = torch.zeros((1,), dtype=torch.int32, device=dev)
    # the heaviest first, so that no long query starts last
    work = estimated_work(q, q_sq, series, sq_norms, order, sorted_lb, M, k,
                          K)
    schedule = torch.argsort(work, descending=True,
                             stable=True).to(torch.int32)
    fn = _build.entry("refine", "refine_search", _ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(q.data_ptr(), q_sq.data_ptr(), series.data_ptr(),
                  _DTYPES[series.dtype], sq_norms.data_ptr(),
                  order.data_ptr(), sorted_lb.data_ptr(), schedule.data_ptr(),
                  out_d.data_ptr(), out_e.data_ptr(), rounds.data_ptr(),
                  alive.data_ptr(), counter.data_ptr(), Q, L, K, M, k,
                  order.shape[1], torch.cuda.current_stream().cuda_stream)
    _build.check("refine", "refine_search", code)
    launches += 1
    return out_d, out_e, rounds
