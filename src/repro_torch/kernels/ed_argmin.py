"""Exact 1-NN scan: per-query min squared Euclidean distance and argmin.

On CUDA tensors `ed_argmin` launches the kernel of `csrc/ed_argmin.cu`,
which streams the candidates at their stored width through the tensor
cores (three TF32 products for float32 candidates, two for bfloat16 ones,
which are exact in TF32) and never materializes the (Q, N) distance
matrix.  Its producer loads the candidates by TMA where their rows are
whole 16-byte pieces on an aligned base, else with cp.async into the
same layout (`route`), for every L and alignment, without a copy of the
candidates; on CPU tensors it runs the plain version `ref.ed_argmin_ref`.
`launches` counts the kernel's launches, `by_route` those of each route.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .ref import ed_argmin_ref

launches = 0
by_route: dict = {}                    # launches of each route

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("tensor", "staged")
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [
    ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
QUERY_GROUP = 256                      # queries per block of the kernel
CHUNK = 32                             # columns a chunk of the kernel's ring


def route(L: int, dtype: torch.dtype = torch.float32,
          aligned: bool = True) -> str:
    """The loader of the candidates, rows of length L in `dtype` on a base
    16-byte aligned or not: "tensor" (TMA) where a row is whole 16-byte
    pieces (L a multiple of 4 in float32, of 8 in bfloat16) and the base
    aligned, so TMA can take it; "staged" (cp.async, into the same layout)
    for any other.  Both run the same tensor-core products."""
    elem = torch.finfo(dtype).bits // 8
    return "tensor" if aligned and (L * elem) % 16 == 0 else "staged"


def scratch_floats(Q: int, L: int) -> int:
    """The kernel's scratch: q_hi and q_lo (Qpad, Lp) and |q|^2 (Qpad,),
    Qpad = Q rounded up to QUERY_GROUP, Lp = L rounded up to CHUNK (zero
    columns, so that the queries' TMA maps have 16-byte strides)."""
    q_pad = -(-Q // QUERY_GROUP) * QUERY_GROUP
    return 2 * q_pad * (-(-L // CHUNK) * CHUNK) + q_pad


def ed_argmin(q: torch.Tensor, xs: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (Q, L) float32, xs: (N, L) float32 or bfloat16 -> ((Q,) float32
    min d^2, (Q,) int32 argmin), d^2 in matmul form, ties to the lowest
    index; any Q and L (query groups on the grid's x), by `route(L,
    xs.dtype, base aligned)`.

    Raises ValueError/TypeError on input the kernel does not take, and
    RuntimeError if a launch fails.
    """
    if q.dim() != 2 or xs.dim() != 2 or q.shape[1] != xs.shape[1]:
        raise ValueError(f"need q (Q, L) and xs (N, L), got "
                         f"{tuple(q.shape)}, {tuple(xs.shape)}")
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32, got {q.dtype}")
    if xs.dtype not in _DTYPES:
        raise TypeError(f"xs must be float32 or bfloat16, got {xs.dtype}")
    if not (q.is_contiguous() and xs.is_contiguous()):
        raise ValueError("ed_argmin takes contiguous tensors")
    if q.device != xs.device:
        raise ValueError("q and xs must share a device")
    Q, L = q.shape
    N = xs.shape[0]
    if Q == 0 or N == 0:
        raise ValueError(f"need Q >= 1 queries and N >= 1 candidates, got "
                         f"{Q}, {N}")
    if N >= 2**31:
        raise ValueError(f"the argmin is int32: N={N} must be < 2^31")
    if q.device.type == "cpu":
        return ed_argmin_ref(q, xs)
    if q.device.type != "cuda":
        raise RuntimeError(f"no ed_argmin kernel for device {q.device}")
    return launch(q, xs, route(L, xs.dtype, xs.data_ptr() % 16 == 0))


def launch(q: torch.Tensor, xs: torch.Tensor, how: str
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on CUDA tensors q, xs that `ed_argmin` has checked, by
    route `how`: "staged" takes any shape, "tensor" those that route()
    gives it (ValueError for another).  Counts the launch."""
    global launches
    (Q, L), N = q.shape, xs.shape[0]
    if how not in ROUTES or (
            how == "tensor"
            and route(L, xs.dtype, xs.data_ptr() % 16 == 0) != how):
        raise ValueError(f"ed_argmin cannot take route {how!r} at L {L}, "
                         f"{xs.dtype}, base {xs.data_ptr() % 16} mod 16")
    scratch = torch.empty((scratch_floats(Q, L),), dtype=torch.float32,
                          device=q.device)
    keys = torch.empty((Q,), dtype=torch.int64, device=q.device)
    out_d = torch.empty((Q,), dtype=torch.float32, device=q.device)
    out_i = torch.empty((Q,), dtype=torch.int32, device=q.device)
    fn = _build.entry("ed_argmin", "ed_argmin", _ARGTYPES)
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), xs.data_ptr(), _DTYPES[xs.dtype],
                  scratch.data_ptr(), keys.data_ptr(), out_d.data_ptr(),
                  out_i.data_ptr(), Q, N, L, ROUTES.index(how),
                  torch.cuda.current_stream().cuda_stream)
    _build.check("ed_argmin", "ed_argmin", code)
    launches += 1
    by_route[how] = by_route.get(how, 0) + 1
    return out_d, out_i
