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
they are bound by the TF32 rate.  Past dh 512 O is computed in chunks of
columns, each chunk's blocks taking all of the scores: on the tensor
cores in chunks of 192 or 256, bfloat16 ("tcc<w>", "stagedc<w>") with
the scores over dh in 64-column pieces, float32 in TF32 ("tfc<w>") where
a row is whole 16-byte pieces, to dh 1,024; other float32 rows on the
FMAs in chunks of 320 ("simtc320"). On CPU tensors it runs the plain version
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
# past 512, O in chunks of these widths on the tensor cores (wgmma's N is
# at most 256), each chunk's blocks computing all of the scores; float32
# rows that are not whole 16-byte pieces, which TMA cannot take, in
# chunks of SIMT_CHUNK on the FMAs (at least two: a thread's O of a wider
# chunk spills past 255 registers)
CHUNKS = (192, 256)
SIMT_CHUNK = 320
# the widest dh the TF32 chunks take: three TF32 products a term err by
# ~2^-21 of each, and a sum over more columns of dh carries that past the
# float32 limit the checks hold (at dh 2,048 it did on the H100); wider
# float32 rows take the FMAs
TF32_CHUNK_MAX = 1024
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_float,
                                                            ctypes.c_void_p])
# query rows a block, by route kind: "tc" and "staged" (TMA over padded
# copies) on the tensor cores in bf16, "tcc" and "stagedc" (O in chunks),
# "tf" and "tfc" (O in chunks) in TF32, "simt" and "simtc" on the FMAs
ROWS = {"tc": 128, "staged": 128, "tcc": 64, "stagedc": 64, "tf": 64,
        "tfc": 128, "simt": 64, "simtc": 64}
MAX_QBLOCKS = 65535                          # the grid's y dimension
# csrc/flash_attention.cu, namespace chunk: the bf16 chunks' layout
CHUNK_PIECE = 64 * 64 * 2                    # a 64 x 64 TMA box of bf16
CHUNK_STAGES = 4                             # K-piece stages a consumer
SMEM_MAX = 232448                            # shared memory a block may take


def chunk_width(dh: int) -> int:
    """The columns of O a tensor-core block computes past dh 512: O in
    ceil(dh / 256) chunks, each the narrowest of CHUNKS at least its
    share of dh (192 to dh 576, else 256)."""
    n = -(-dh // CHUNKS[-1])
    return next(w for w in CHUNKS if w >= -(-dh // n))


def chunk_smem(dh: int, width: int, stream_q: bool) -> int:
    """Shared memory bytes of a bfloat16 chunk block (csrc's
    chunk::Layout::smem): Q whole (ceil(dh / 64) pieces of 8 KB) unless
    streamed, two consumers' rings of CHUNK_STAGES K-piece stages (with
    the Q piece where streamed) and one V stage of width / 64 pieces,
    the hand-over of the max and sum, the barriers, 1 KB of alignment."""
    q = 0 if stream_q else -(-dh // 64) * CHUNK_PIECE
    ring = (CHUNK_STAGES * (2 if stream_q else 1) + width // 64) * CHUNK_PIECE
    return 1024 + q + 2 * ring + 128 * 16 + 8 * (2 * (2 * CHUNK_STAGES + 2)
                                                 + 1)


def chunk_regs(width: int) -> int:
    """Registers a consumer thread of a bfloat16 chunk block holds for its
    tiles: O (64 x width f32 over 128 threads), S (64 x 64) and P_hi,
    P_lo (bf16x2 each), against the 232-240 of setmaxnreg."""
    return width // 2 + 64 // 2 + 2 * (64 // 16) * 4


def route(dtype: torch.dtype, dh: int) -> str:
    """The kernel route of head width dh: w the narrowest instance of
    INSTANCES + HALVES at least dh; for bfloat16 "tc<w>" (the tensor
    cores fed by TMA) where a row is whole 16-byte pieces (dh a multiple
    of 8), else "staged<w>" (the same instance, TMA reading copies whose
    rows are padded to 16-byte pieces); for float32 "tf256" from dh 129
    to 256 (the tensor cores in TF32, three products a term, over split
    copies of K and V: bound by the TF32 rate), else "simt<w>" (float32
    FMAs, bound by their rate; 16-byte loads where dh % 4 == 0).  Past
    512, O in chunks of w = chunk_width(dh) columns on the tensor cores:
    bfloat16 "tcc<w>" or "stagedc<w>" (as above), float32 "tfc<w>" (in
    TF32, as tf256) where a row is whole 16-byte pieces (dh % 4 == 0) to
    TF32_CHUNK_MAX, else "simtc320" (the FMAs, chunks of SIMT_CHUNK)."""
    widths = INSTANCES + HALVES
    if dh > widths[-1]:
        w = chunk_width(dh)
        if dtype != torch.bfloat16:
            tf32 = dh % 4 == 0 and dh <= TF32_CHUNK_MAX
            return f"tfc{w}" if tf32 else f"simtc{SIMT_CHUNK}"
        return f"{'tcc' if dh % 8 == 0 else 'stagedc'}{w}"
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
    halves and chunks (simt past 256) put pairs of query blocks on the
    grid's x, one launch for any T; a staged route launches its padding
    first, the TF32 route its split of K and V."""
    kind = _kind(name)
    if kind == "simtc" or (kind == "simt" and int(name[4:]) > INSTANCES[-1]):
        return 1
    blocks = -(-T // ROWS[kind])
    return -(-blocks // MAX_QBLOCKS) + (kind in ("staged", "stagedc", "tf",
                                                  "tfc"))


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
           *, causal: bool = True, window: int = 0,
           stream_q: bool = False) -> torch.Tensor:
    """The kernel of route `name` on CUDA tensors that `flash_attention`
    has checked: the route(q.dtype, dh) gives, or another that takes the
    shape (a "staged<w>" for the "tc<w>" of the same width, a "stagedc<w>"
    for the "tcc<w>", to hold the padded copies to the tensors themselves;
    "simtc320" for a "tfc<w>", the FMAs beside the TF32 tensor cores;
    ValueError for one that does not).  stream_q: a bfloat16 chunk route
    streams Q beside K even where Q fits whole in shared memory (which it
    takes otherwise).  Counts the launches."""
    global launches
    B, Hq, T, dh = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    kind, want = _kind(name), route(q.dtype, dh)
    ok = name == want or (kind in ("staged", "stagedc")
                          and want == f"tc{name[6:]}") or (
        name == f"simtc{SIMT_CHUNK}" and want.startswith("tfc"))
    if not ok:
        raise ValueError(f"flash_attention cannot take route {name!r} at "
                         f"dh {dh}, {q.dtype} (its route: {want!r})")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the flash_attention kernels read 16-byte pieces "
                         "(by TMA for bfloat16): q, k, v must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    scratch = None
    if kind in ("staged", "stagedc"):
        # rows padded to whole 16-byte pieces, which TMA takes
        scratch = torch.empty(((B * Hq * T + 2 * B * Hkv * S)
                               * -(-dh // 8) * 8,), dtype=q.dtype,
                              device=q.device)
    elif kind in ("tf", "tfc"):
        scratch = torch.empty((tf32_scratch(B, Hkv, S, dh),),
                              dtype=torch.float32, device=q.device)
    fn = _build.entry("flash_attention", "flash_attention", _ARGTYPES)
    chunked = kind in ("tcc", "stagedc", "tfc", "simtc")
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  scratch.data_ptr() if scratch is not None else None,
                  _DTYPES[q.dtype], B, Hq, Hkv, T, S, dh,
                  int(name[len(kind):]), (1 + bool(stream_q)) if chunked
                  else 0, int(causal), int(window), dh ** -0.5,
                  torch.cuda.current_stream().cuda_stream)
    _build.check("flash_attention", "flash_attention", code)
    n = query_launches(T, name)
    with _build.COUNT_LOCK:
        launches += n
        by_route[name] = by_route.get(name, 0) + n
    return out
