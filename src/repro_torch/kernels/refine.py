"""One refinement round: gather + distances + prune + top-k fold.

On CUDA tensors `refine_topk` launches a kernel of `csrc/refine.cu`, by
the route `route` picks from the shapes (a persistent grid taking query
rows in turn, each row's alive leaves streamed through a ring of bulk
copies, their candidates folded 256 at a time; or one block a row, its
alive leaves staged through shared memory, folded once by selection and
merge); each reads only the alive leaves, at their stored width, and
never materializes the (Q, K*M, L) gather.  On CPU tensors it runs the
plain version `ref.refine_topk_ref`.  `launches` counts the kernel's
launches.
Every round of a search in one launch is `refine_search.py`'s, whose
input checks are the ones below.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build
from .ref import refine_topk_ref

launches = 0
by_route: dict = {}                    # launches of each route

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ROUTES = ("ring", "general")
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 7
             + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
# csrc/refine.cu's layout constants
_SMEM_MAX = 232448                     # shared memory a block may take
_SMEM_SM = 233472                      # an SM's
_THREADS, _WARPS = 256, 8
_MAX_STAGES = 4


def ring_rows(parts, L: int, M: int, elem: int, blocks: int) -> int:
    """The leaf rows a stage of a layout of csrc/refine.cu holds at
    `blocks` CTAs an SM (0: it does not fit): its fixed parts ((bytes,
    alignment) in order), then two stages of at least one leaf row and its
    norms' window, the leaf halved until two fit.  The same arithmetic as
    the source's `layout` and `place_ring`, term for term."""
    off = 0
    for nbytes, align in parts:
        off = -(-off // align) * align + nbytes
    room = min(_SMEM_MAX, _SMEM_SM // blocks - 1024) - off

    def stage(rows: int) -> int:
        return rows * L * elem + (rows + 9) // 4 * 16
    rows = M
    while rows > 1 and 2 * stage(rows) > room:
        rows = (rows + 1) // 2
    return rows if room >= 0 and 2 * stage(rows) <= room else 0


def ring_fits(parts, L: int, M: int, elem: int, blocks: int) -> bool:
    """Whether a layout of csrc/refine.cu fits `blocks` CTAs an SM
    (ring_rows)."""
    return ring_rows(parts, L, M, elem, blocks) > 0


def _fits(L: int, K: int, M: int, k: int, elem: int, blocks: int) -> bool:
    """Whether `topk::layout` lays refine_topk's shared memory out for
    `blocks` CTAs an SM."""
    n_ent, W = max(_THREADS, K), max(1, _THREADS // K)
    return ring_fits(((8 * _MAX_STAGES, 8), (4 * (_MAX_STAGES + 1) * L, 16),
                      (4 * n_ent, 4), (4 * n_ent, 4), (4 * n_ent, 4),
                      (4 * n_ent, 4), (4 * W, 4), (4 * W, 4), (4 * W, 4),
                      (4 * K, 4), (4 * (_WARPS + 1), 4), (4 * K * M, 16),
                      (4 * k, 4), (4 * k, 4), (4 * k, 4), (4 * k, 4),
                      (4 * _THREADS, 4), (4 * _THREADS, 4), (0, 128)),
                     L, M, elem, blocks)


@functools.lru_cache(maxsize=None)
def route(L: int, K: int, M: int, k: int, dtype: torch.dtype) -> str:
    """The kernel route of one round: "ring" (a CTA a query row in turn,
    all the row's alive leaves streamed through a ring of bulk copies
    into shared memory, their candidates folded 256 at a time) where a
    row is whole 16-byte pieces and the layout fits at 4, 3, 2 or 1 CTAs
    an SM; "general" (a block a row: the alive leaves staged through
    shared memory, each row read in the widest pieces its length allows,
    one fold of the round over all K * M candidates by selection and
    merge, its lists in shared memory where they fit, else in global
    scratch) for every other shape.  A pure function of the shapes (so cached: the
    sharded search launches one a shard a round); the wrapper realigns a
    base that is not 16-byte aligned."""
    elem = torch.finfo(dtype).bits // 8
    # csrc lays the ring kernel out for 4, 3, 2 or 1 CTAs an SM, the first
    # that fits; it fits for some iff it fits for one
    if (L * elem) % 16 == 0 and _fits(L, K, M, k, elem, 1):
        return "ring"
    return "general"


def general_words(K: int, M: int) -> int:
    """Float32 words of global scratch a query row of the general route
    takes: its alive slots and their leaves (K each), the distances (K
    M) and the passing candidates' keys (2 words each, room for the power
    of two at or above K M, at least 2), each part even; csrc/refine.cu's
    general_topk_words."""
    P = 2
    while P < K * M:
        P *= 2
    return 2 * ((K + 1) // 2 * 2) + (K * M + 1) // 2 * 2 + 2 * P


def aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a fresh (16-byte aligned) copy where its base is not."""
    return t.clone() if t.data_ptr() % 16 else t


def pad_norms(sq_norms: torch.Tensor) -> torch.Tensor:
    """sq_norms, or a copy padded to a multiple of 4 entries: the fast
    kernels copy a leaf's norms as a 16-byte aligned window, which must
    not run past the end."""
    if sq_norms.shape[0] % 4:
        return torch.nn.functional.pad(sq_norms,
                                       (0, 4 - sq_norms.shape[0] % 4))
    return sq_norms


def _dims(q, series, M: int, k: int, K: int):
    """(Q, L) of q, once the sizes both refine kernels take hold."""
    if q.dim() != 2:
        raise ValueError(f"q must be (Q, L), got {tuple(q.shape)}")
    Q, L = q.shape
    if M < 1 or k < 1 or K < 1:
        raise ValueError(f"need leaf_capacity, k and K >= 1, got {M}, {k}, "
                         f"{K}")
    if series.dim() != 2 or series.shape[1] != L or series.shape[0] % M:
        raise ValueError(f"series must be (n_leaves * {M}, {L}), got "
                         f"{tuple(series.shape)}")
    return Q, L


def _check_tensors(what: str, q, series, want: dict) -> None:
    """Each of `want` ({name: (tensor, shape, dtype)}) as it says, series
    of a dtype the kernels read, and all contiguous on q's device."""
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} of shape {shape}, got "
                             f"{t.dtype} of shape {tuple(t.shape)}")
    if series.dtype not in _DTYPES:
        raise TypeError(f"series must be float32, bfloat16 or float16, got "
                        f"{series.dtype}")
    for t in [series] + [t for t, _, _ in want.values()]:
        if not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors")
        if t.device != q.device:
            raise ValueError(f"{what}'s tensors must share a device")


def _check(q, q_sq, series, sq_norms, leaf_ids, alive, bsf_d, bsf_e,
           M: int, k: int) -> None:
    if leaf_ids.dim() != 2:
        raise ValueError(f"leaf_ids must be (Q, K), got "
                         f"{tuple(leaf_ids.shape)}")
    K = leaf_ids.shape[1]
    Q, L = _dims(q, series, M, k, max(K, 1))
    _check_tensors("refine_topk", q, series, {
        "q_sq": (q_sq, (Q,), torch.float32),
        "sq_norms": (sq_norms, (series.shape[0],), torch.float32),
        "alive": (alive, (Q, K), torch.bool),
        "leaf_ids": (leaf_ids, (Q, K), torch.int32),
        "bsf_d": (bsf_d, (Q, k), torch.float32),
        "bsf_e": (bsf_e, (Q, k), torch.int32),
        "q": (q, (Q, L), torch.float32)})


def refine_topk(q: torch.Tensor, q_sq: torch.Tensor, series: torch.Tensor,
                sq_norms: torch.Tensor, leaf_ids: torch.Tensor,
                alive: torch.Tensor, bsf_d: torch.Tensor,
                bsf_e: torch.Tensor, *, leaf_capacity: int, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused refinement round.

    q:        (Q, L) f32 prepared queries
    q_sq:     (Q,)   f32 |q|^2
    series:   (n_pad, L) leaf-ordered series, f32/bf16/f16 (math in f32)
    sq_norms: (n_pad,)   f32 |x|^2 (padded rows at 1e30)
    leaf_ids: (Q, K) int32 leaves to visit this round; each must be a
              leaf of `series` (the search makes them so)
    alive:    (Q, K) bool, lb < the round-start k-th best (pruning mask)
    bsf_d/e:  (Q, k) f32 / int32 carried top-k buffer, ascending
    -> the merged (Q, k) buffer, ties to the lower union index with
       buffer slots first.  Raises ValueError/TypeError on input the
       kernel does not take, and RuntimeError if a launch fails.
    """
    global launches
    M = leaf_capacity
    _check(q, q_sq, series, sq_norms, leaf_ids, alive, bsf_d, bsf_e, M, k)
    if q.device.type == "cpu":
        return refine_topk_ref(q, q_sq, series, sq_norms, leaf_ids, alive,
                               bsf_d, bsf_e, leaf_capacity=M, k=k)
    if q.device.type != "cuda":
        raise RuntimeError(f"no refine_topk kernel for device {q.device}")
    Q, L = q.shape
    K = leaf_ids.shape[1]
    how = route(L, K, M, k, series.dtype)
    q, series = aligned(q), aligned(series)
    if how == "ring":
        sq_norms = pad_norms(aligned(sq_norms))
    out_d = torch.empty((Q, k), dtype=torch.float32, device=q.device)
    out_e = torch.empty((Q, k), dtype=torch.int32, device=q.device)
    if Q == 0:
        return out_d, out_e
    scratch = (torch.empty((Q, general_words(K, M)), dtype=torch.float32,
                           device=q.device) if how == "general" else None)
    fn = _build.entry("refine", "refine_topk", _ARGTYPES)
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), q_sq.data_ptr(), series.data_ptr(),
                  _DTYPES[series.dtype], sq_norms.data_ptr(),
                  leaf_ids.data_ptr(), alive.data_ptr(), bsf_d.data_ptr(),
                  bsf_e.data_ptr(), out_d.data_ptr(), out_e.data_ptr(),
                  Q, L, K, M, k, _ROUTES.index(how),
                  None if scratch is None else scratch.data_ptr(),
                  torch.cuda.current_stream().cuda_stream)
    _build.check("refine", "refine_topk", code)
    launches += 1
    by_route[how] = by_route.get(how, 0) + 1
    return out_d, out_e
