"""Causal and/or sliding-window softmax attention with grouped KV heads.

On CUDA tensors `flash_attention` launches a kernel of
`csrc/flash_attention.cu`, which streams K/V tiles with an online
softmax and never materializes the (T, S) scores, by the route `route`
picks from the dtype and the head width: bfloat16 inputs go to the
tensor cores (wgmma fed by TMA, P carried as two bf16 halves), float32
inputs to float32 FMAs, each in instances of width 32, 64, 96, 128 and
256 that take every narrower dh (padded with zeros in shared memory),
and bfloat16 to dh 512 in instances whose blocks each compute one half
of O's columns; a wider dh, or one whose rows are not whole 16-byte
pieces, takes the "wide" route (float32 FMAs, no TMA).  On CPU tensors
it runs the plain version `ref.flash_attention_ref`.  `launches` counts
the kernels' launches, `by_route` those of each route.  There is no
gradient: repro's kernel has none.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import flash_attention_ref

launches = 0
by_route: dict = {}                    # launches of each route

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
INSTANCES = (32, 64, 96, 128, 256)     # the widths of the padded instances
# bfloat16 past 256 (wgmma's N is at most 256): instances whose blocks each
# compute one half of O's columns
HALVES = (320, 384, 448, 512)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_float,
                                                            ctypes.c_void_p])
ROWS = {"tc": 128, "simt": 64, "wide": 16}   # query rows a block, by route
MAX_QBLOCKS = 65535                          # the grid's y dimension


def route(dtype: torch.dtype, dh: int) -> str:
    """The kernel route of head width dh: "tc<w>" (bfloat16, the tensor
    cores) or "simt<w>" (float32 FMAs), w the narrowest instance of
    INSTANCES (and for bfloat16 of HALVES) at least dh, where a row is
    whole 16-byte pieces (a multiple of 8 bf16 or 4 f32 values: TMA's,
    and the FMA route's float4 loads); "wide" for every other dh (any
    width, either dtype, no TMA)."""
    bf16 = dtype == torch.bfloat16
    widths = INSTANCES + (HALVES if bf16 else ())
    if dh > widths[-1] or dh % (8 if bf16 else 4):
        return "wide"
    width = next(w for w in widths if w >= dh)
    return f"{'tc' if bf16 else 'simt'}{width}"


def query_launches(T: int, name: str) -> int:
    """Launches of route `name` at T query rows: a block takes ROWS of
    them (by the route's kind), and a launch's grid at most MAX_QBLOCKS
    blocks in its y dimension, so a longer T takes more launches (the
    last blocks, the heaviest under a causal mask, first)."""
    blocks = -(-T // ROWS[name.rstrip("0123456789")])
    return -(-blocks // MAX_QBLOCKS)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Hq, T, dh); k, v: (B, Hkv, S, dh), one dtype, float32 or
    bfloat16 -> (B, Hq, T, dh) in q's dtype.  Query head h reads KV head
    h // (Hq // Hkv); scores are scaled by dh^-0.5; `window` > 0 keeps the
    keys s with s > t - window.  Any dh, T and B * Hq, by `route(dtype,
    dh)`, in `query_launches(T, route)` launches.

    Raises ValueError/TypeError on input the kernel does not take, and
    RuntimeError if a launch fails.
    """
    global launches
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, Hq, T, dh) and k, v (B, Hkv, S, dh), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, T, dh = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"k, v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch or head width")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    if min(B, Hq, T, S, dh) < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    for t in (q, k, v):
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise TypeError(f"q, k, v must share one dtype, float32 or "
                            f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
        if not t.is_contiguous():
            raise ValueError("flash_attention takes contiguous tensors")
        if t.device != q.device:
            raise ValueError("q, k and v must share a device")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise RuntimeError(f"no flash_attention kernel for device "
                           f"{q.device}")
    name = route(q.dtype, dh)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the flash_attention kernels read 16-byte pieces "
                         "(by TMA for bfloat16): q, k, v must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    fn = _build.entry("flash_attention", "flash_attention", _ARGTYPES)
    width = 0 if name == "wide" else int(name[2:] if name[:2] == "tc"
                                         else name[4:])
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  _DTYPES[q.dtype], B, Hq, Hkv, T, S, dh, width, int(causal),
                  int(window), dh ** -0.5,
                  torch.cuda.current_stream().cuda_stream)
    _build.check("flash_attention", "flash_attention", code)
    n = query_launches(T, name)
    with _build.COUNT_LOCK:
        launches += n
        by_route[name] = by_route.get(name, 0) + n
    return out
