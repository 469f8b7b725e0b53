"""The flat FreSh index on torch tensors.

The paper's leaf-oriented tree, flattened as `repro.core.index` does it:
every series is summarized (PAA + iSAX word, the summarize kernel), the
series are sorted by the round-robin bit-interleaved iSAX key, so leaves
are blocks of M consecutive entries, and each leaf gets a dense
per-segment [lo, hi] region for one of three sound lower bounds
('prefix', 'symbox', 'paabox').
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.isax_summarize import \
    summarize_rows as _summarize_rows
from repro_torch.kernels.leaf_stats import leaf_stats
# the leaf_stats kernel's plain version, under repro.core.index's names
from repro_torch.kernels.ref import (  # noqa: F401
    _bit_length_u8, leaf_stats_blocks)

from . import isax

# rows per step where a full-size temporary would double the series' memory
_CHUNK_ROWS = 1 << 20
# the storage dtypes of the series matrix, by IndexConfig.dtype
STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


class FlatIndex(NamedTuple):
    """The device-resident index; fields, dtypes and meanings as in
    `repro.core.index.FlatIndex`."""
    series: torch.Tensor       # (n_pad, L) z-normalized, leaf order
    paa: torch.Tensor          # (n_pad, w) f32
    words: torch.Tensor        # (n_pad, w) uint8
    sq_norms: torch.Tensor     # (n_pad,)   |x|^2, 1e30 for padding
    perm: torch.Tensor         # (n_pad,)   int32 original id; -1 padding
    valid: torch.Tensor        # (n_pad,)   bool
    leaf_lo: torch.Tensor      # (n_leaves, w) region lower edge (f32)
    leaf_hi: torch.Tensor      # (n_leaves, w) region upper edge (f32)
    leaf_valid: torch.Tensor   # (n_leaves,) bool

    @property
    def leaf_capacity(self) -> int:
        return self.series.shape[0] // self.leaf_lo.shape[0]

    @property
    def n_leaves(self) -> int:
        return self.leaf_lo.shape[0]


def lexsort_lanes(lanes: torch.Tensor) -> torch.Tensor:
    """Stable ascending order of (n, n_lanes) non-negative 31-bit key
    lanes, lane 0 primary: `jnp.lexsort(tuple(reversed(lanes)))`.

    Two lanes pack into one int64 (62 bits), so five lanes take three
    stable sorts, applied from the least significant key to the most.
    """
    cols = [lanes[:, i].to(torch.int64) for i in range(lanes.shape[1])]
    keys = [(cols[i] << 31) | cols[i + 1] if i + 1 < len(cols) else cols[i]
            for i in range(0, len(cols), 2)]
    perm = torch.arange(lanes.shape[0], device=lanes.device)
    for key in reversed(keys):
        _, order = torch.sort(key[perm], stable=True)
        perm = perm[order]
    return perm


def summarize_rows(raw: torch.Tensor, *, segments: int, bits: int,
                   znorm: bool):
    """(series f32, paa, words uint8, sq_norms) of raw (n, L) rows through
    the summarize kernel, one launch per block of _CHUNK_ROWS rows, each
    writing its slice of the full-size outputs in place (only a block of
    raw is converted when it is neither float32 nor bfloat16).  The
    kernel gives each row the same bits whatever block it lies in: the
    index builder's parts launch it on theirs, and store what
    `build_index` stores."""
    n, L = raw.shape
    dev = raw.device
    x = torch.empty((n, L), dtype=torch.float32, device=dev)
    p = torch.empty((n, segments), dtype=torch.float32, device=dev)
    w = torch.empty((n, segments), dtype=torch.int32, device=dev)
    sq = torch.empty((n,), dtype=torch.float32, device=dev)
    for s in range(0, n, _CHUNK_ROWS):
        c = raw[s:s + _CHUNK_ROWS]
        if c.dtype not in (torch.float32, torch.bfloat16):
            c = c.float()
        _summarize_rows(c.contiguous(), segments=segments, bits=bits,
                        znorm=znorm, out=tuple(t[s:s + _CHUNK_ROWS]
                                               for t in (x, p, w, sq)))
    return x, p, w.to(torch.uint8), sq


def build_index(raw: torch.Tensor, *, segments: int = isax.SEGMENTS,
                bits: int = isax.SAX_BITS, leaf_capacity: int = 64,
                znorm: bool = True, bound: str = "prefix") -> FlatIndex:
    """Bulk index construction over raw (n, L) float series, on raw's
    device.  n is padded up to a whole number of leaves.

    Memory: beyond `raw`, the build holds the normalized series and their
    leaf-ordered copy at once (two float32 copies of the data), then only
    the latter.
    """
    n, L = raw.shape
    x, p, w, sq = summarize_rows(raw, segments=segments, bits=bits,
                                 znorm=znorm)

    # ---- sort by interleaved key (leaf order of the round-robin tree) ----
    perm = lexsort_lanes(isax.interleaved_key(w, bits))
    # ---- per-leaf regions, read through the order (what the builder's
    # leaf_stats phase calls on each of its parts) --------------------------
    lo, hi, leaf_valid = leaf_stats(p, w, perm, n,
                                    leaf_capacity=leaf_capacity, bits=bits,
                                    bound=bound)
    x, p, w, sq = x[perm], p[perm], w[perm], sq[perm]
    perm = perm.to(torch.int32)

    # ---- pad to a whole number of leaves ---------------------------------
    n_pad = -(-n // leaf_capacity) * leaf_capacity
    pad = n_pad - n
    if pad:
        x = torch.cat([x, x.new_zeros((pad, L))])
        # padded symbols = max symbol; padded PAA = +inf so boxes stay tight
        p = torch.cat([p, p.new_full((pad, segments), float("inf"))])
        w = torch.cat([w, w.new_full((pad, segments), (1 << bits) - 1)])
        perm = torch.cat([perm, perm.new_full((pad,), -1)])
        sq = torch.cat([sq, sq.new_zeros((pad,))])
    valid = perm >= 0

    # padded rows must never win a min: push their norms (hence distances) up
    sq_norms = torch.where(valid, sq, torch.full_like(sq, 1e30))

    return FlatIndex(series=x, paa=p, words=w, sq_norms=sq_norms,
                     perm=perm, valid=valid, leaf_lo=lo, leaf_hi=hi,
                     leaf_valid=leaf_valid)


def pad_leaves(idx: FlatIndex, multiple: int) -> FlatIndex:
    """Append fully padded (invalid) leaves so n_leaves % multiple == 0.

    Padded leaves carry empty regions at 1e30 (lower bound 1e30: never a
    candidate), rows of zeros, PAA +inf, words 0, norms 1e30, perm -1 and
    valid False, as `repro.core.index.pad_leaves` appends them, so search
    results are unchanged; this lets any index shard over any number of
    slots.  Returns idx itself when nothing is missing (no copy)."""
    target = -(-idx.n_leaves // multiple) * multiple
    extra = target - idx.n_leaves
    if extra == 0:
        return idx
    rows = extra * idx.leaf_capacity
    L, w = idx.series.shape[1], idx.paa.shape[1]

    def cat(a, shape, value):
        return torch.cat([a, a.new_full(shape, value)])

    return FlatIndex(
        series=cat(idx.series, (rows, L), 0),
        paa=cat(idx.paa, (rows, w), float("inf")),
        words=cat(idx.words, (rows, w), 0),
        sq_norms=cat(idx.sq_norms, (rows,), 1e30),
        perm=cat(idx.perm, (rows,), -1),
        valid=cat(idx.valid, (rows,), False),
        leaf_lo=cat(idx.leaf_lo, (extra, w), 1e30),
        leaf_hi=cat(idx.leaf_hi, (extra, w), 1e30),
        leaf_valid=cat(idx.leaf_valid, (extra,), False))


def index_stats(idx: FlatIndex) -> dict:
    """Host-side summary: series, leaves, capacity and leaf fill."""
    fill = idx.valid.reshape(idx.n_leaves, -1).sum(dim=1)
    return {"n_series": int(idx.valid.sum()),
            "n_leaves": int(idx.n_leaves),
            "leaf_capacity": idx.leaf_capacity,
            "mean_fill": float(fill.double().mean()),
            "min_fill": int(fill.min()),
            "max_fill": int(fill.max())}
