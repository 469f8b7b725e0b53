"""Every refinement round of a search in one launch.

`refine_search` runs each query's rounds until its own stop (exact, or
the (1 + eps) stop of the quality rules, `inv_eps`), which gives the
buffer of repro's global loop of `refine_topk` rounds.  On CUDA
tensors it launches the `refine_search` kernel of `csrc/refine.cu`, by the
route `route` picks from the shapes (thread-block clusters of 8 CTAs a
query, cut to a divisor of K, shared memory for 3, 2 or 1 CTAs an SM; or
one CTA a query with its buffers in global scratch), taking the queries
heaviest first; on CPU tensors it runs the plain version
`ref.refine_search_ref`.  `launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .ref import refine_search_ref
from .refine import (_DTYPES, _MAX_STAGES, _THREADS, _WARPS,
                     _check_tensors, _dims, aligned, pad_norms, ring_fits)

launches = 0
by_route: dict = {}                    # launches of each route

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 9
             + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 2
             + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])
_CLUSTER, _INFO = 8, 4         # csrc/refine.cu, namespace search
ROUTES = ("cta3", "cta2", "cta1", "general")


def cluster_size(K: int) -> int:
    """CTAs a query: 8, cut to the largest power of two dividing K."""
    C = _CLUSTER
    while K % C:
        C //= 2
    return C


def _fits(L: int, K: int, M: int, k: int, elem: int, blocks: int) -> bool:
    """Whether `layout` in csrc/refine.cu (namespace search) lays shared
    memory out for `blocks` CTAs an SM."""
    J, n_it = K // cluster_size(K), -(-K * M // _THREADS)
    return ring_fits(((8 * _MAX_STAGES, 8), (16, 16), (4 * L, 16),
                      (8 * J * M, 16), (8 * J, 4), (4 * k, 4), (4 * k, 4),
                      (4 * k, 4), (4 * k, 4), (4 * K * M, 4), (4 * K * M, 4),
                      (4 * _INFO * K, 4), (4 * _INFO * K, 4),
                      (4 * n_it * _WARPS, 4), (0, 128)),
                     L, M, elem, blocks)


def route(L: int, K: int, M: int, k: int, dtype: torch.dtype) -> str:
    """The kernel route of a search's refinement: search_kernel with its
    shared memory laid out for 3 CTAs an SM ("cta3", the first choice),
    else 2 ("cta2"), else 1 ("cta1"), where a row is whole 16-byte pieces;
    else search_general ("general": one CTA a query, values read one at a
    time, buffers in global scratch), which takes every shape.  A pure
    function of the shapes; the wrapper realigns a base that is not
    16-byte aligned."""
    elem = torch.finfo(dtype).bits // 8
    if (L * elem) % 16 == 0:
        for blocks in (3, 2, 1):
            if _fits(L, K, M, k, elem, blocks):
                return f"cta{blocks}"
    return "general"


def general_words(K: int, M: int, k: int) -> int:
    """Float32 words of global scratch a CTA of the general route takes:
    the candidates, both buffers, the passing candidates, warp counts."""
    return 3 * K * M + 4 * k + -(-K * M // _THREADS) * _WARPS


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
                   k: int, K: int, inv_eps: float = 1.0) -> torch.Tensor:
    """Each query's leaves whose lower bound lies below its bound after
    the first round (the k-th best of the members of its first K leaves,
    times inv_eps), as (Q,) int64.

    The bound only falls, so every slot alive after the first round is
    one of these leaves: a cheap overestimate of the query's work (K
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
    kth = d2.kthvalue(k, dim=1).values * inv_eps
    return torch.searchsorted(sorted_lb, kth.contiguous()[:, None])[:, 0]


def refine_search(q: torch.Tensor, q_sq: torch.Tensor, series: torch.Tensor,
                  sq_norms: torch.Tensor, order: torch.Tensor,
                  sorted_lb: torch.Tensor, *, leaf_capacity: int, k: int,
                  round_leaves: int, inv_eps: float = 1.0,
                  alive_out: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every refinement round of a search, from the empty buffer.

    q, q_sq, series, sq_norms as for `refine.refine_topk`;
    order:     (Q, cap * K) int32 leaf ids of each query's priority queue,
               ascending in lower bound (each a leaf of `series`)
    sorted_lb: (Q, cap * K) f32 their lower bounds, padding at BIG
    inv_eps:   the stop rule's scale 1/(1+eps)^2: a slot is alive while
               its lower bound lies below the k-th best times
               float32(inv_eps), a float32 product as repro forms it;
               1.0 (the default) is the exact search, bit for bit
    alive_out: optional (Q,) int32, receives each query's alive slots;
               they are the first that many entries of its queue, since
               the queue ascends and the bound never grows
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
                                 inv_eps=inv_eps, alive_out=alive_out)
    if q.device.type != "cuda":
        raise RuntimeError(f"no refine_search kernel for device {q.device}")
    Q, L = q.shape
    how = route(L, K, M, k, series.dtype)
    q, series = aligned(q), aligned(series)
    sq_norms = pad_norms(aligned(sq_norms))
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
                          K, inv_eps)
    schedule = torch.argsort(work, descending=True,
                             stable=True).to(torch.int32)
    if how == "general":
        ctas = min(Q, 2 * torch.cuda.get_device_properties(
            dev).multi_processor_count)
        per = general_words(K, M, k)
        scratch = torch.empty((ctas, per), dtype=torch.float32, device=dev)
    else:
        ctas, per, scratch = int(how[3:]), 0, None
    fn = _build.entry("refine", "refine_search", _ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(q.data_ptr(), q_sq.data_ptr(), series.data_ptr(),
                  _DTYPES[series.dtype], sq_norms.data_ptr(),
                  order.data_ptr(), sorted_lb.data_ptr(), schedule.data_ptr(),
                  out_d.data_ptr(), out_e.data_ptr(), rounds.data_ptr(),
                  alive.data_ptr(), counter.data_ptr(), Q, L, K, M, k,
                  order.shape[1], inv_eps, int(how == "general"), ctas,
                  None if scratch is None else scratch.data_ptr(), per,
                  torch.cuda.current_stream().cuda_stream)
    _build.check("refine", "refine_search", code)
    launches += 1
    by_route[how] = by_route.get(how, 0) + 1
    return out_d, out_e, rounds
