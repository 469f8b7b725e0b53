"""Causal and/or sliding-window softmax attention with grouped KV heads.

On CUDA tensors `flash_attention` launches a kernel of
`csrc/flash_attention.cu`, which streams K/V tiles with an online
softmax (on the tiles of 64 and 32 keys past dh 128, O and l on a stale
row max that moves only where a tile's max passes it by more than 8 in
log2 units) and never materializes the (T, S) scores, by the route
`route` picks from the dtype and the head width, in instances of width
32, 64, 96, 128 and 256 that take every narrower dh (padded with zeros),
and to dh 512 in instances whose blocks each compute one half of O's
columns. bfloat16 inputs go to the tensor cores (wgmma, P carried as two
bf16 halves), which read their tiles by TMA, from q, k and v where a row
is whole 16-byte pieces ("tc<w>"), else from copies whose rows a first
kernel pads to them ("staged<w>"); at 256 on 64-key tiles. float32
inputs go to float32 FMAs ("simt<w>") to dh 128 and past 256, and from
dh 129 to 256 to the tensor cores in TF32 ("tf256"): three TF32 products
a term (hi = tf32(x), lo = x - hi) keep float32's accuracy, on copies of
K and V split into hi and lo (V transposed) that a first kernel writes;
they are bound by the TF32 rate. Only a dh past 512 takes the "wide"
route (float32 FMAs, no TMA). On CPU tensors it runs the plain version
`ref.flash_attention_ref`. `launches` counts the kernels' launches,
`by_route` those of each route. There is no gradient: repro's kernel has
none.
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
# past 256 (wgmma's N is at most 256, and float32 tiles pass shared
# memory): instances whose blocks each compute one half of O's columns
HALVES = (320, 384, 448, 512)
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_float,
                                                            ctypes.c_void_p])
# query rows a block, by route kind: "tc" and "staged" (TMA over padded
# copies) on the tensor cores in bf16, "tf" in TF32, "simt" on the FMAs,
# "wide"
ROWS = {"tc": 128, "staged": 128, "tf": 64, "simt": 64, "wide": 16}
MAX_QBLOCKS = 65535                          # the grid's y dimension


def route(dtype: torch.dtype, dh: int) -> str:
    """The kernel route of head width dh: w the narrowest instance of
    INSTANCES + HALVES at least dh; for bfloat16 "tc<w>" (the tensor
    cores fed by TMA) where a row is whole 16-byte pieces (dh a multiple
    of 8), else "staged<w>" (the same instance, TMA reading copies whose
    rows are padded to 16-byte pieces); for float32 "tf256" from dh 129
    to 256 (the tensor cores in TF32, three products a term, over split
    copies of K and V: bound by the TF32 rate), else "simt<w>" (float32
    FMAs, bound by their rate; 16-byte loads where dh % 4 == 0); "wide"
    past 512 (either dtype, no TMA)."""
    widths = INSTANCES + HALVES
    if dh > widths[-1]:
        return "wide"
    width = next(w for w in widths if w >= dh)
    if dtype != torch.bfloat16:
        return f"{'tf' if 128 < dh <= 256 else 'simt'}{width}"
    return f"{'tc' if dh % 8 == 0 else 'staged'}{width}"


def _kind(name: str) -> str:
    return name.rstrip("0123456789")


def query_launches(T: int, name: str) -> int:
    """Launches of route `name` at T query rows: a block takes ROWS of
    them (by the route's kind), and a launch's grid at most MAX_QBLOCKS
    blocks in its y dimension, so a longer T takes more launches (the
    last blocks, the heaviest under a causal mask, first); the float32
    halves (simt past 256) put pairs of query blocks on the grid's x,
    one launch for any T; a staged route launches its padding first, the
    TF32 route its split of K and V."""
    kind = _kind(name)
    if kind == "simt" and int(name[4:]) > INSTANCES[-1]:
        return 1
    blocks = -(-T // ROWS[kind])
    return -(-blocks // MAX_QBLOCKS) + (kind in ("staged", "tf"))


def tf32_scratch(B: int, Hkv: int, S: int, dh: int) -> int:
    """float32 values of the TF32 route's copies: K_hi and K_lo (B Hkv, S,
    dh rounded up to 4) and V^T_hi and V^T_lo (B Hkv, dh, S rounded up to
    8), about four times K's size."""
    return 2 * B * Hkv * (S * -(-dh // 4) * 4 + dh * -(-S // 8) * 8)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Hq, T, dh); k, v: (B, Hkv, S, dh), one dtype, float32 or
    bfloat16 -> (B, Hq, T, dh) in q's dtype.  Query head h reads KV head
    h // (Hq // Hkv); scores are scaled by dh^-0.5; `window` > 0 keeps the
    keys s with s > t - window.  Any dh, T and B * Hq, by `route(dtype,
    dh)`, in `query_launches(T, route)` launches.  The TF32 route (float32
    at dh 129 to 256) takes scratch of four times K's size for its split
    copies of K and V (`tf32_scratch`: 8 MB at B 1, Hkv 2, S 1024, dh
    256; about 1 GB at S 32,768 with Hkv 8); the staged route (bfloat16
    rows not whole 16-byte pieces) one padded copy of q, k and v.

    Raises ValueError/TypeError on input the kernel does not take, and
    RuntimeError if a launch fails.
    """
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
    return launch(q, k, v, route(q.dtype, dh), causal=causal,
                  window=window)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, name: str,
           *, causal: bool = True, window: int = 0) -> torch.Tensor:
    """The kernel of route `name` on CUDA tensors that `flash_attention`
    has checked: the route(q.dtype, dh) gives, or another that takes the
    shape (a "staged<w>" for the "tc<w>" of the same width, to hold the
    padded copies to the tensors themselves; ValueError for one that does
    not).  Counts the launches."""
    global launches
    B, Hq, T, dh = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    kind, want = _kind(name), route(q.dtype, dh)
    ok = name == want or (kind == "staged" and want == f"tc{name[6:]}")
    if not ok:
        raise ValueError(f"flash_attention cannot take route {name!r} at "
                         f"dh {dh}, {q.dtype} (its route: {want!r})")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the flash_attention kernels read 16-byte pieces "
                         "(by TMA for bfloat16): q, k, v must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    scratch = None
    if kind == "staged":
        # rows padded to whole 16-byte pieces, which TMA takes
        scratch = torch.empty(((B * Hq * T + 2 * B * Hkv * S)
                               * -(-dh // 8) * 8,), dtype=q.dtype,
                              device=q.device)
    elif kind == "tf":
        scratch = torch.empty((tf32_scratch(B, Hkv, S, dh),),
                              dtype=torch.float32, device=q.device)
    fn = _build.entry("flash_attention", "flash_attention", _ARGTYPES)
    width = 0 if kind == "wide" else int(name[len(kind):])
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  scratch.data_ptr() if scratch is not None else None,
                  _DTYPES[q.dtype], B, Hq, Hkv, T, S, dh, width, int(causal),
                  int(window), dh ** -0.5,
                  torch.cuda.current_stream().cuda_stream)
    _build.check("flash_attention", "flash_attention", code)
    n = query_launches(T, name)
    with _build.COUNT_LOCK:
        launches += n
        by_route[name] = by_route.get(name, 0) + n
    return out
