"""Exact 1-NN scan: per-query min squared Euclidean distance and argmin.

On CUDA tensors `ed_argmin` launches the kernel of `csrc/ed_argmin.cu`,
which streams the candidates at their stored width through the tensor
cores (three TF32 products for float32 candidates, two for bfloat16 ones,
which are exact in TF32) and never materializes the (Q, N) distance
matrix; a row length that is not a multiple of 8 takes the kernel's
general route (`route`), float32 FMAs; on CPU tensors it runs the plain
version `ref.ed_argmin_ref`.  `launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .ref import ed_argmin_ref
from .refine import aligned

launches = 0
by_route: dict = {}                    # launches of each route

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = ("tensor", "general")
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [
    ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_QUERY_GROUP = 256                     # queries per block of the kernel


def route(L: int) -> str:
    """The kernel route for rows of length L: "tensor" (TMA loads, the
    tensor cores) where L is a multiple of 8, so rows lie on 16-byte
    boundaries; "general" (float32 FMAs, values one at a time) for any
    other L.  The wrapper realigns a base that is not 16-byte aligned."""
    return "tensor" if L % 8 == 0 else "general"


def ed_argmin(q: torch.Tensor, xs: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (Q, L) float32, xs: (N, L) float32 or bfloat16 -> ((Q,) float32
    min d^2, (Q,) int32 argmin), d^2 in matmul form, ties to the lowest
    index; any Q (the tensor-core route's grid takes query groups in x,
    the general route's in y, 65,535 groups of 32 a launch, so more
    queries take more launches).

    Raises ValueError/TypeError on input the kernel does not take, and
    RuntimeError if a launch fails.
    """
    global launches
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
    how = route(L)
    q, xs = aligned(q), aligned(xs)
    q_pad = -(-Q // _QUERY_GROUP) * _QUERY_GROUP
    # q_hi, q_lo (q_pad, L) and |q|^2 (q_pad,), written by the kernel
    scratch = torch.empty((2 * q_pad * L + q_pad,), dtype=torch.float32,
                          device=q.device)
    keys = torch.empty((Q,), dtype=torch.int64, device=q.device)
    out_d = torch.empty((Q,), dtype=torch.float32, device=q.device)
    out_i = torch.empty((Q,), dtype=torch.int32, device=q.device)
    fn = _build.entry("ed_argmin", "ed_argmin", _ARGTYPES)
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), xs.data_ptr(), _DTYPES[xs.dtype],
                  scratch.data_ptr(), keys.data_ptr(), out_d.data_ptr(),
                  out_i.data_ptr(), Q, N, L, _ROUTES.index(how),
                  torch.cuda.current_stream().cuda_stream)
    _build.check("ed_argmin", "ed_argmin", code)
    launches += 1
    by_route[how] = by_route.get(how, 0) + 1
    return out_d, out_i
