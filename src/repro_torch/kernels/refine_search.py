"""Every refinement round of a search in one launch.

`refine_search` runs each query's rounds until its own stop (exact, or
the (1 + eps) stop of the quality rules, `inv_eps`), which gives the
buffer of repro's global loop of `refine_topk` rounds.  On CUDA
tensors it launches the `refine_search` kernel of `csrc/refine.cu`, by the
route `route` picks from the shapes, taking the queries heaviest first;
on CPU tensors it runs the plain version `ref.refine_search_ref`.
`launches` counts the kernel's launches, `by_route` each route's.

A round folds its candidates below the k-th best into the buffer by
selection and merge (`ref.select_merge_fold` is its plain model): each
CTA of a query's cluster sorts its own candidates as keys and keeps the
first k, every CTA merges the cluster's runs, and buffer slots and
candidates take their ranks by binary search.  The routes:

    cta3 / cta2 / cta1        clusters of 8 CTAs a query (cut to a divisor
                              of K), the buffer whole in every CTA, shared
                              memory for 3 / 2 / 1 CTAs an SM
    spread3 / spread2 /       the same with the buffer in slices of
      spread1                 ceil(k / C) slots over the cluster, each CTA
                              folding its own slice (from k = SPREAD_K,
                              and where the whole buffer does not fit)
    general                   one CTA a query, rows read one value at a
                              time, buffers in global scratch: rows that
                              are not whole 16-byte pieces, and shapes
                              past both layouts
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .ref import refine_search_ref
from .refine import (_DTYPES, _MAX_STAGES, _SMEM_MAX, _check_tensors, _dims,
                     aligned, pad_norms, ring_rows)

launches = 0
by_route: dict = {}                    # launches of each route

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 9
             + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 2
             + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])
_CLUSTER, _INFO, _MISC = 8, 4, 4      # csrc/refine.cu, namespace search
ROUTES = ("cta3", "cta2", "cta1", "spread3", "spread2", "spread1",
          "general")
_CODES = {"cta": 0, "general": 1, "spread": 2}   # refine_search's route
# from this k the buffer goes in slices over the cluster first: at k 1,024
# the whole buffer ran 0.4-8 % faster, at k 2,000 the spread one 5-7 %
# (PERF.md, scripts/refine_fold_routes.py)
SPREAD_K = 1536
# the fewest leaf rows a ring stage should hold: stages of 8 rows (3 CTAs
# an SM at leaves of 256, K 64) ran 1.8x the time of 32 (2 an SM)
MIN_STAGE_ROWS = 16


def cluster_size(K: int) -> int:
    """CTAs a query: 8, cut to the largest power of two dividing K."""
    C = _CLUSTER
    while K % C:
        C //= 2
    return C


def _pow2(n: int) -> int:
    P = 1
    while P < n:
        P *= 2
    return P


def stage_rows(L: int, K: int, M: int, k: int, elem: int, blocks: int,
               spread: bool = False) -> int:
    """The leaf rows a ring stage holds where `layout` in csrc/refine.cu
    (namespace search) lays shared memory out for `blocks` CTAs an SM, the
    buffer whole in each CTA or (spread) in slices over the cluster; 0
    where it does not fit."""
    C = cluster_size(K)
    if spread and C == 1:
        return 0
    J, KM = K // C, K * M
    if KM >= 1 << 30:
        return 0
    S = -(-k // C) if spread else k
    P, runs = _pow2(J * M), min(KM, C * min(J * M, k))
    if 16 * P + 16 * runs + 16 * S > _SMEM_MAX:
        return 0
    return ring_rows(((8 * _MAX_STAGES, 8), (4 * _MISC, 16),
                      (4 * _CLUSTER, 4), (4 * L, 16), (4 * J * M, 16),
                      (16 * P, 16), (8 * runs, 16), (8 * runs, 16),
                      (4 * S, 4), (4 * S, 4), (4 * S, 4), (4 * S, 4),
                      (4 * _INFO * K, 4), (4 * _INFO * K, 4), (0, 128)),
                     L, M, elem, blocks)


def _fits(L: int, K: int, M: int, k: int, elem: int, blocks: int,
          spread: bool = False) -> bool:
    """Whether that layout fits `blocks` CTAs an SM (stage_rows)."""
    return stage_rows(L, K, M, k, elem, blocks, spread) > 0


def route(L: int, K: int, M: int, k: int, dtype: torch.dtype) -> str:
    """The kernel route of a search's refinement (the module's table):
    where a row is whole 16-byte pieces, search_kernel with the buffer
    spread over the cluster from k = SPREAD_K (where the cluster has more
    than one CTA), else whole in every CTA, at the most CTAs an SM (3, 2,
    1) whose ring stages hold MIN_STAGE_ROWS leaf rows (or the whole
    leaf), else at the most that fit; then the other buffer layout the
    same way; else search_general ("general"), which takes every shape.
    A pure function of the shapes; the wrapper realigns a base that is
    not 16-byte aligned."""
    elem = torch.finfo(dtype).bits // 8
    if (L * elem) % 16 == 0:
        first = k >= SPREAD_K and cluster_size(K) > 1
        for spread in (first, not first):
            rows = {b: stage_rows(L, K, M, k, elem, b, spread)
                    for b in (3, 2, 1)}
            fit = [b for b in (3, 2, 1) if rows[b]]
            if fit:
                b = next((b for b in fit
                          if rows[b] >= min(M, MIN_STAGE_ROWS)), fit[0])
                return f"{'spread' if spread else 'cta'}{b}"
    return "general"


def general_words(K: int, M: int, k: int) -> int:
    """Float32 words of global scratch a CTA of the general route takes:
    the distances (K M, made even), the passing candidates' 64-bit keys
    (room for the power of two at or above K M) and both buffers (4 k,
    made even), as csrc/refine.cu's general_words."""
    KM = K * M
    return -(-KM // 2) * 2 + 2 * _pow2(KM) + -(-4 * k // 2) * 2


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
    M, K = leaf_capacity, round_leaves
    _check(q, q_sq, series, sq_norms, order, sorted_lb, M, k, K, alive_out)
    if q.device.type == "cpu":
        return refine_search_ref(q, q_sq, series, sq_norms, order, sorted_lb,
                                 leaf_capacity=M, k=k, round_leaves=K,
                                 inv_eps=inv_eps, alive_out=alive_out)
    if q.device.type != "cuda":
        raise RuntimeError(f"no refine_search kernel for device {q.device}")
    return launch(q, q_sq, series, sq_norms, order, sorted_lb,
                  route(q.shape[1], K, M, k, series.dtype), leaf_capacity=M,
                  k=k, round_leaves=K, inv_eps=inv_eps, alive_out=alive_out)


def launch(q, q_sq, series, sq_norms, order, sorted_lb, how: str, *,
           leaf_capacity: int, k: int, round_leaves: int,
           inv_eps: float = 1.0, alive_out: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`refine_search` on CUDA tensors by the route `how` (one of ROUTES
    whose layout fits the shapes), whatever `route` would pick: the
    comparison of two routes on the card.  Counts the launch."""
    global launches
    M, K = leaf_capacity, round_leaves
    _check(q, q_sq, series, sq_norms, order, sorted_lb, M, k, K, alive_out)
    if q.device.type != "cuda":
        raise RuntimeError(f"no refine_search kernel for device {q.device}")
    Q, L = q.shape
    if how not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {how!r}")
    kind = how.rstrip("123")
    elem = torch.finfo(series.dtype).bits // 8
    if kind != "general" and ((L * elem) % 16 or not _fits(
            L, K, M, k, elem, int(how[-1]), kind == "spread")):
        raise ValueError(f"route {how} does not take L {L}, K {K}, M {M}, "
                         f"k {k}, {series.dtype}")
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
    if kind == "general":
        ctas = min(Q, 2 * torch.cuda.get_device_properties(
            dev).multi_processor_count)
        per = general_words(K, M, k)
        scratch = torch.empty((ctas, per), dtype=torch.float32, device=dev)
    else:
        ctas, per, scratch = int(how[-1]), 0, None
    fn = _build.entry("refine", "refine_search", _ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(q.data_ptr(), q_sq.data_ptr(), series.data_ptr(),
                  _DTYPES[series.dtype], sq_norms.data_ptr(),
                  order.data_ptr(), sorted_lb.data_ptr(), schedule.data_ptr(),
                  out_d.data_ptr(), out_e.data_ptr(), rounds.data_ptr(),
                  alive.data_ptr(), counter.data_ptr(), Q, L, K, M, k,
                  order.shape[1], inv_eps, _CODES[kind], ctas,
                  None if scratch is None else scratch.data_ptr(), per,
                  torch.cuda.current_stream().cuda_stream)
    _build.check("refine", "refine_search", code)
    launches += 1
    by_route[how] = by_route.get(how, 0) + 1
    return out_d, out_e, rounds
