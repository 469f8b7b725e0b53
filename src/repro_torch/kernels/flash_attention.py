"""Causal and/or sliding-window softmax attention with grouped KV heads.

On CUDA tensors `flash_attention` launches a kernel of
`csrc/flash_attention.cu`, which streams K/V tiles with an online
softmax and never materializes the (T, S) scores: bfloat16 inputs go to
the tensor cores (wgmma fed by TMA, P carried as two bf16 halves),
float32 inputs to float32 FMAs.  On CPU tensors it runs the plain
version `ref.flash_attention_ref`.  `launches` counts the kernels'
launches.  There is no gradient: repro's kernel has none.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import flash_attention_ref

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                           ctypes.c_void_p])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Hq, T, dh); k, v: (B, Hkv, S, dh), one dtype, float32 or
    bfloat16 -> (B, Hq, T, dh) in q's dtype.  Query head h reads KV head
    h // (Hq // Hkv); scores are scaled by dh^-0.5; `window` > 0 keeps the
    keys s with s > t - window.

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
    if dh not in _HEAD_DIMS:
        raise ValueError(f"the flash_attention kernel takes dh in "
                         f"{_HEAD_DIMS}, got {dh}")
    if B * Hq > 65535:
        raise ValueError(f"the flash_attention kernel's grid takes "
                         f"B * Hq <= 65535, got {B * Hq}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the flash_attention kernels read 16-byte pieces "
                         "(by TMA for bfloat16): q, k, v must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    fn = _build.entry("flash_attention", "flash_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  _DTYPES[q.dtype], B, Hq, Hkv, T, S, dh, int(causal),
                  int(window), dh ** -0.5,
                  torch.cuda.current_stream().cuda_stream)
    _build.check("flash_attention", "flash_attention", code)
    launches += 1
    return out
