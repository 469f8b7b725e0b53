"""iSAX summarization: (z-norm) -> PAA -> symbols in one pass per series.

On a CUDA tensor `summarize` (and `summarize_rows`, which also returns
what the index build stores: the float32 series and their squared norms)
launches the kernel of `csrc/isax_summarize.cu`, by the route `route`
picks from the shapes; on a CPU tensor it runs the plain version
`ref.summarize_ref` (`ref.summarize_rows_ref`).  `launches` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core import isax

from . import _build
from .ref import summarize_ref, summarize_rows_ref
from .refine import aligned

launches = 0
by_route: dict = {}                    # launches of each route

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = ("lanes", "strided")
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
             + [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _check(x: torch.Tensor, segments: int, bits: int) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be (n, L), got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in [1, 8], got {bits}")
    L = x.shape[1]
    if segments < 1 or L % segments:
        raise ValueError(f"L={L} is not divisible by segments={segments}")


def route(L: int, segments: int, dtype: torch.dtype) -> str:
    """The kernel route for rows of length L cut into `segments`:
    "lanes" where L = 32 lanes * VPT values, VPT in {4, 8, 16, 32}
    (float32) or {8, 16, 32} (bfloat16), whole 16-byte lane slices, and
    a segment that spans a power-of-two count of lanes or fits whole
    inside one lane; "strided" (one value a load) for every other L and
    segment count.  A pure function of the shapes, so CPU tests can ask
    it; the wrapper realigns a row base that is not 16-byte aligned."""
    vpts = (4, 8, 16, 32) if dtype == torch.float32 else (8, 16, 32)
    if L % 32 or L // 32 not in vpts:
        return "strided"
    vpt, seg = L // 32, L // segments
    if seg >= vpt:
        g = seg // vpt
        ok = seg % vpt == 0 and g & (g - 1) == 0
    else:
        ok = vpt % seg == 0
    return "lanes" if ok else "strided"


def _outputs(n: int, L: int, segments: int, device, rows: bool, out):
    """The launch's outputs: `out` where given (checked: the shapes,
    dtypes and device of the fresh ones, contiguous), else fresh."""
    shapes = (((n, L), torch.float32), ((n, segments), torch.float32),
              ((n, segments), torch.int32), ((n,), torch.float32))
    if not rows:
        shapes = shapes[1:3]
    if out is None:
        return tuple(torch.empty(s, dtype=t, device=device)
                     for s, t in shapes)
    if len(out) != len(shapes) or any(
            tuple(o.shape) != s or o.dtype != t or o.device != device
            or not o.is_contiguous() for o, (s, t) in zip(out, shapes)):
        raise ValueError("out must be contiguous (series, paa, words, "
                         "sq_norms) of shapes (n, L), (n, w), (n, w), (n,), "
                         "dtypes f32, f32, i32, f32, on x's device")
    return tuple(out)


def _launch(x: torch.Tensor, segments: int, bits: int, znorm: int,
            rows: bool, out=None):
    """Launch the kernel on CUDA tensor x: (paa, words) and, with rows,
    the float32 series and their squared norms, written into `out` where
    given."""
    global launches
    if x.device.type != "cuda":
        raise RuntimeError(f"no summarize kernel for device {x.device}")
    x = aligned(x)
    n, L = x.shape
    how = route(L, segments, x.dtype)
    dev = x.device
    bp = isax.table("breakpoints", bits, torch.float32, dev)
    out = _outputs(n, L, segments, dev, rows, out)
    xout, paa, words, sqn = out if rows else (None,) + out + (None,)
    if n == 0:
        return out
    fn = _build.entry("isax_summarize", "isax_summarize", _ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(x.data_ptr(), _DTYPES[x.dtype], bp.data_ptr(), bp.numel(),
                  paa.data_ptr(), words.data_ptr(),
                  xout.data_ptr() if rows else None,
                  sqn.data_ptr() if rows else None, n, L, segments, znorm,
                  _ROUTES.index(how),
                  torch.cuda.current_stream().cuda_stream)
    _build.check("isax_summarize", "isax_summarize", code)
    with _build.COUNT_LOCK:
        launches += 1
        by_route[how] = by_route.get(how, 0) + 1
    return out


def summarize(x: torch.Tensor, *, segments: int = isax.SEGMENTS,
              bits: int = isax.SAX_BITS, znorm: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (n, L) f32/bf16 -> (paa (n, w) f32, words (n, w) int32).

    znorm=True z-normalizes each series first, in the one-pass
    E[x^2] - mu^2 form of the TPU kernel on the card.  Raises
    ValueError/TypeError on input the kernel does not take, and
    RuntimeError if a launch fails.
    """
    _check(x, segments, bits)
    if x.device.type == "cpu":
        return summarize_ref(x, segments, bits, znorm)
    return _launch(x, segments, bits, 1 if znorm else 0, False)


def summarize_rows(x: torch.Tensor, *, segments: int = isax.SEGMENTS,
                   bits: int = isax.SAX_BITS, znorm: bool = True, out=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """What the index build stores of each row, in one pass:
    x (n, L) f32/bf16 -> (series (n, L) f32, z-normalized if znorm as
    `isax.znormalize` does it (the mean, then the deviations), paa (n, w)
    f32, words (n, w) int32, squared norms (n,) f32).

    One warp reduces each row in a fixed order, so a row gets the same
    bits whatever rows share its launch: the builder's parts and the
    one-shot build store the same index.  `out`, four tensors of those
    shapes and dtypes (slices of larger ones, say), receives the result
    in place.  Raises as `summarize`.
    """
    _check(x, segments, bits)
    if x.device.type == "cpu":
        res = summarize_rows_ref(x, segments, bits, znorm)
        if out is None:
            return res
        out = _outputs(*x.shape, segments, x.device, True, out)
        for o, r in zip(out, res):
            o.copy_(r)
        return out
    return _launch(x, segments, bits, 2 if znorm else 0, True, out)
