"""Core iSAX math on torch tensors: z-normalization, PAA, iSAX words, the
bit-interleaved sort key and the per-segment region bounds.

The PyTorch counterpart of `repro.core.isax`.  The breakpoint table is
host-side numpy (Acklam's inverse normal CDF, copied as is so the two
packages quantize against the same float64 table); everything else is a
plain function on tensors that runs on whatever device its input lives on.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

# Defaults: the paper's setup, series of length 256, w = 16 segments,
# 8-bit symbols.
SERIES_LEN = 256
SEGMENTS = 16
SAX_BITS = 8
CARDINALITY = 1 << SAX_BITS

_ACKLAM_A = (-3.969683028665376e+01, 2.209460984245205e+02,
             -2.759285104469687e+02, 1.383577518672690e+02,
             -3.066479806614716e+01, 2.506628277459239e+00)
_ACKLAM_B = (-5.447609879822406e+01, 1.615858368580409e+02,
             -1.556989798598866e+02, 6.680131188771972e+01,
             -1.328068155288572e+01)
_ACKLAM_C = (-7.784894002430293e-03, -3.223964580411365e-01,
             -2.400758277161838e+00, -2.549732539343734e+00,
             4.374664141464968e+00, 2.938163982698783e+00)
_ACKLAM_D = (7.784695709041462e-03, 3.224671290700398e-01,
             2.445134137142996e+00, 3.754408661907416e+00)


def ndtri(p: np.ndarray) -> np.ndarray:
    """Inverse standard-normal CDF (Acklam's approximation), numpy."""
    p = np.asarray(p, dtype=np.float64)
    out = np.empty_like(p)
    a, b, c, d = _ACKLAM_A, _ACKLAM_B, _ACKLAM_C, _ACKLAM_D
    plow, phigh = 0.02425, 1.0 - 0.02425

    lo = p < plow
    hi = p > phigh
    mid = ~(lo | hi)

    if np.any(lo):
        q = np.sqrt(-2.0 * np.log(p[lo]))
        out[lo] = ((((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5])
                   / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1.0))
    if np.any(hi):
        q = np.sqrt(-2.0 * np.log(1.0 - p[hi]))
        out[hi] = -((((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5])
                    / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1.0))
    if np.any(mid):
        q = p[mid] - 0.5
        r = q * q
        out[mid] = ((((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q
                    / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1.0))
    return out


@functools.lru_cache(maxsize=None)
def breakpoints(bits: int = SAX_BITS) -> np.ndarray:
    """The 2^bits - 1 interior N(0,1) quantile breakpoints, ascending (f64)."""
    card = 1 << bits
    return ndtri(np.arange(1, card) / card)


@functools.lru_cache(maxsize=None)
def padded_breakpoints(bits: int = SAX_BITS) -> np.ndarray:
    """Breakpoints padded with -inf / +inf: region of symbol v is
    [pad[v], pad[v + 1]].  Length 2^bits + 1."""
    return np.concatenate([[-np.inf], breakpoints(bits), [np.inf]])


@functools.lru_cache(maxsize=None)
def table(name: str, bits: int, dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    """The `breakpoints` or `padded_breakpoints` table as a tensor on
    `device`, made once: a copy from host memory per call would wait for
    the device each time (and the builder's worker threads for one
    another)."""
    fn = breakpoints if name == "breakpoints" else padded_breakpoints
    return torch.as_tensor(fn(bits), dtype=dtype, device=device)


def znormalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Per-series z-normalization over the last axis.  The standard
    deviation is the population one (`correction=0`), as `jnp.std`."""
    mu = x.mean(dim=-1, keepdim=True)
    sd = x.std(dim=-1, keepdim=True, correction=0)
    return (x - mu) / (sd + eps)


def paa(x: torch.Tensor, segments: int = SEGMENTS) -> torch.Tensor:
    """Piecewise Aggregate Approximation: the mean of each of `segments`
    equal slices of the last axis.  x: (..., n) -> (..., segments)."""
    n = x.shape[-1]
    if n % segments:
        raise ValueError(f"series length {n} not divisible by w={segments}")
    return x.reshape(*x.shape[:-1], segments, n // segments).mean(dim=-1)


def sax_word(paa_vals: torch.Tensor, bits: int = SAX_BITS) -> torch.Tensor:
    """Quantize PAA values into iSAX symbols at full cardinality:
    searchsorted(breakpoints, value, side="right").  uint8 for bits <= 8,
    int32 otherwise."""
    bp = table("breakpoints", bits, paa_vals.dtype, paa_vals.device)
    sym = torch.searchsorted(bp, paa_vals.contiguous(), right=True)
    return sym.to(torch.uint8 if bits <= 8 else torch.int32)


def summarize(x: torch.Tensor, segments: int = SEGMENTS,
              bits: int = SAX_BITS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Series -> (paa, isax_word)."""
    p = paa(x, segments)
    return p, sax_word(p, bits)


def root_bucket(words: torch.Tensor, bits: int = SAX_BITS) -> torch.Tensor:
    """First-bit signature: the MSB of each segment's symbol, packed into
    an int, the root subtree an iSAX index routes a series to (paper
    Section V-A).  words: (..., w) -> (...,) int32 in [0, 2^w)."""
    w = words.shape[-1]
    msb = (words.to(torch.int32) >> (bits - 1))
    weights = 1 << torch.arange(w - 1, -1, -1, dtype=torch.int32,
                                device=words.device)
    return (msb * weights).sum(dim=-1, dtype=torch.int32)


def interleaved_key(words: torch.Tensor, bits: int = SAX_BITS) -> torch.Tensor:
    """Round-robin bit-interleaved sort key, packed into int32 lanes.

    Bit i (0 = most significant) of the w*bits-bit key is bit
    (bits - 1 - i // w) of segment i % w.  The key is cut into lanes of
    31 bits (the last lane holds the remainder), so the sign bit stays 0
    and lexicographic comparison of the lane tuple equals comparison of
    the full key.  words: (..., w) -> (..., n_lanes) int32, bit-exact with
    `repro.core.isax.interleaved_key`.
    """
    w = words.shape[-1]
    cols = [words[..., s].to(torch.int64) for s in range(w)]
    bitpos = [(s, b) for b in range(bits - 1, -1, -1) for s in range(w)]
    lanes = []
    for start in range(0, w * bits, 31):
        acc = torch.zeros_like(cols[0])
        for s, b in bitpos[start:start + 31]:
            acc = (acc << 1) | ((cols[s] >> b) & 1)
        lanes.append(acc.to(torch.int32))
    return torch.stack(lanes, dim=-1)


def interleaved_key_np(words: np.ndarray, bits: int = SAX_BITS) -> np.ndarray:
    """`interleaved_key` in numpy, for the builder's host-side key, sort
    and merge phases: integer math only, bit-identical to it and to
    `repro.core.isax.interleaved_key_np`.  (n, w) -> (n, n_lanes) int32."""
    words = np.asarray(words).astype(np.int32)
    w = words.shape[-1]
    # planes[..., b * w + s] = bit (bits - 1 - b) of segment s: MSB plane
    # first, as `interleaved_key` walks them
    shifts = np.arange(bits - 1, -1, -1, dtype=np.int32)[:, None]
    planes = ((words[..., None, :] >> shifts) & 1).reshape(
        words.shape[:-1] + (bits * w,))
    lanes = []
    for lane_start in range(0, w * bits, 31):
        chunk = planes[..., lane_start:lane_start + 31]
        weights = np.int32(1) << np.arange(chunk.shape[-1] - 1, -1, -1,
                                           dtype=np.int32)
        lanes.append(chunk @ weights)
    return np.stack(lanes, axis=-1).astype(np.int32)


def lexsort_keys(keys: np.ndarray) -> np.ndarray:
    """Stable ascending order of (n, n_lanes) keys, lane 0 primary (numpy's
    lexsort takes its primary key last); ties keep their positions, which
    is what makes merging sorted runs equal one global stable sort."""
    return np.lexsort(tuple(keys[:, i]
                            for i in range(keys.shape[1] - 1, -1, -1)))


def pack_keys_bytes(keys: np.ndarray) -> np.ndarray:
    """(n, n_lanes) non-negative int32 lanes -> (n,) fixed-width byte
    strings whose memcmp order is the lanes' lexicographic order
    (big-endian uint32 bytes, lane after lane): a scalar key that
    np.searchsorted can binary-search when a run is merged."""
    be = np.ascontiguousarray(keys.astype(">u4"))
    return be.view(f"S{4 * keys.shape[1]}").reshape(-1)


def euclidean_sq(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distance along the last axis (broadcasts)."""
    d = q - x
    return (d * d).sum(dim=-1)


def euclidean(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(euclidean_sq(q, x))


def paa_lb_sq(q_paa: torch.Tensor, x_paa: torch.Tensor,
              series_len: int = SERIES_LEN) -> torch.Tensor:
    """Squared PAA lower bound:  (n/w) * ||PAA(q) - PAA(x)||^2  <=  ED^2."""
    w = q_paa.shape[-1]
    return (series_len / w) * euclidean_sq(q_paa, x_paa)


def symbol_region(sym: torch.Tensor, depth_bits, bits: int = SAX_BITS,
                  dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) of the N(0,1) region covered by symbol `sym` when only its
    top `depth_bits` bits are considered (an iSAX tree-node prefix).
    depth_bits is an int or a tensor that broadcasts against sym."""
    pad = table("padded_breakpoints", bits, dtype, sym.device)
    shift = bits - torch.as_tensor(depth_bits, dtype=torch.int64,
                                   device=sym.device)
    base = (sym.to(torch.int64) >> shift) << shift
    lo = pad[base]
    hi = pad[base + (torch.ones_like(shift) << shift)]
    return lo, hi


def mindist_region_sq(q_paa: torch.Tensor, lo: torch.Tensor,
                      hi: torch.Tensor,
                      series_len: int = SERIES_LEN) -> torch.Tensor:
    """Squared MINDIST between a query PAA and a per-segment [lo, hi]
    region: 0 inside, else the squared distance to the nearer edge, summed
    over segments and scaled by L/w.  Broadcasts; returns (...,)."""
    w = q_paa.shape[-1]
    d = (lo - q_paa).clamp_min(0.0) + (q_paa - hi).clamp_min(0.0)
    return (series_len / w) * (d * d).sum(dim=-1)


def mindist_isax_sq(q_paa: torch.Tensor, words: torch.Tensor,
                    depth_bits=SAX_BITS, bits: int = SAX_BITS,
                    series_len: int = SERIES_LEN) -> torch.Tensor:
    """Squared lower-bound distance MINDIST(Q, iSAX(X)) (paper Section
    II): the point-to-region bound of `symbol_region` at `depth_bits`
    (an int or a tensor that broadcasts; `bits` is the full-cardinality
    bound, fewer emulate internal tree nodes)."""
    lo, hi = symbol_region(words, depth_bits, bits, dtype=q_paa.dtype)
    return mindist_region_sq(q_paa, lo, hi, series_len)
