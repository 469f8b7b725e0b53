"""iSAX summarization: (z-norm) -> PAA -> symbols in one pass per series.

On a CUDA tensor `summarize` launches the kernel of
`csrc/isax_summarize.cu`; on a CPU tensor it runs the plain version
`ref.summarize_ref`.  `launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core import isax

from . import _build
from .ref import summarize_ref

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


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


def _kernel_shape_ok(x: torch.Tensor, segments: int) -> bool:
    """L = 32 lanes * VPT values, VPT whole 16-byte loads (at most 32
    values) from a 16-byte aligned base, and a segment that either spans
    a power-of-two count of lanes or fits whole inside one lane."""
    L = x.shape[1]
    vpt, per16 = L // 32, 16 // x.element_size()
    if L % 32 or vpt % per16 or vpt > 32 or x.data_ptr() % 16:
        return False
    seg = L // segments
    if seg >= vpt:
        g = seg // vpt
        return seg % vpt == 0 and g & (g - 1) == 0
    return vpt % seg == 0


def summarize(x: torch.Tensor, *, segments: int = isax.SEGMENTS,
              bits: int = isax.SAX_BITS, znorm: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (n, L) f32/bf16 -> (paa (n, w) f32, words (n, w) int32).

    znorm=True z-normalizes each series first, in the one-pass
    E[x^2] - mu^2 form on the card.  Raises ValueError/TypeError on
    input the kernel does not take, and RuntimeError if a launch fails.
    """
    global launches
    _check(x, segments, bits)
    if x.device.type == "cpu":
        return summarize_ref(x, segments, bits, znorm)
    if x.device.type != "cuda":
        raise RuntimeError(f"no summarize kernel for device {x.device}")
    if not _kernel_shape_ok(x, segments):
        raise ValueError(f"the summarize kernel takes L = 32 * VPT with "
                         f"whole, aligned 16-byte lane slices and segments "
                         f"that map onto lanes; got L={x.shape[1]}, "
                         f"segments={segments}, dtype={x.dtype}")
    n, L = x.shape
    bp = torch.as_tensor(isax.breakpoints(bits), dtype=torch.float32,
                         device=x.device)
    paa = torch.empty((n, segments), dtype=torch.float32, device=x.device)
    words = torch.empty((n, segments), dtype=torch.int32, device=x.device)
    if n == 0:
        return paa, words
    fn = _build.entry("isax_summarize", "isax_summarize", _ARGTYPES)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), _DTYPES[x.dtype], bp.data_ptr(), bp.numel(),
                  paa.data_ptr(), words.data_ptr(), n, L, segments,
                  int(znorm), torch.cuda.current_stream().cuda_stream)
    _build.check("isax_summarize", "isax_summarize", code)
    launches += 1
    return paa, words
