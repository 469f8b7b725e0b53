"""The analytic roofline of the port's kernels on an NVIDIA H100.

One home for every kernel's work count.  Each `*_work` function returns
a `Work`: the bytes one call must move (each input read once, each
output written once), the operations it must issue, and the peak rate
of those operations' type.  `Work.bound()` is the least time the card
could take, the larger of the bytes over the memory rate and the
operations over that peak (`bound_ms`).  `chip_smoke.py`'s bounds come
from here, so a kernel's roofline reads the same work whatever
implements it.  Where the work depends on the data (the slots alive in a
round, the cells an abandoning DP needs), the caller counts it on the
run's own data and passes the count.

Besides, `repro.launch.roofline`'s analytic part under the same names:
`refine_analytic`, `roofline_fraction`, `device_peaks` (over the typed
peaks of `DEVICE_PEAKS`), `model_flops_for` and `Roofline`.  repro's HLO
walker (`analyze_hlo`, `analyze`) has no counterpart: it reads XLA's HLO
text, and the port compiles no XLA; the work counts here do its job.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional, Tuple

import torch

# NVIDIA H100 SXM, the data sheet's dense rates at the 700 W limit
HBM_BYTES_PER_S = 3.35e12      # device memory
F32_FLOPS = 67e12              # float32 FMAs outside the tensor cores
TF32_FLOPS = 495e12            # tf32 tensor cores
BF16_FLOPS = 989e12            # bf16 tensor cores
# float32 instructions that are not FMAs (add, sub, max): one a lane a
# clock, 132 SMs x 128 lanes x 1.98 GHz boost
F32_ISSUE = 132 * 128 * 1.98e9

#: (hbm bytes/s, {type: operations/s}) per device-kind SUBSTRING, matched
#: case-insensitively against the device's name.  The h100 entry is the
#: card the port runs on, by type: "bf16", "tf32", "f32" (FMAs, two
#: flops each) and "f32_issue" (float32 instructions that are not FMAs).
#: The others are repro's entries, at its one type ("bf16"; v100's rate
#: is its fp16 tensor cores); the cpu entry is repro's nominal server
#: figure.  No TPU entry.
DEVICE_PEAKS = {
    "cpu": (5.0e10, {"bf16": 2.0e11}),
    "a100": (1555e9, {"bf16": 312e12}),
    "h100": (HBM_BYTES_PER_S, {"bf16": BF16_FLOPS, "tf32": TF32_FLOPS,
                               "f32": F32_FLOPS, "f32_issue": F32_ISSUE}),
    "v100": (900e9, {"bf16": 125e12}),
}


def device_peaks(kind: Optional[str] = None,
                 dtype: str = "bf16") -> Tuple[float, float]:
    """(peak operations/s of `dtype`, hbm bytes/s) of device kind `kind`
    (None = the live CUDA device's name).  Substring match over
    `DEVICE_PEAKS`.

    Raises ValueError for a kind no entry matches (repro falls back to
    TPU constants there) or a type its entry lacks, and RuntimeError
    for kind=None without CUDA."""
    if kind is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass the device "
                               "kind, e.g. 'NVIDIA H100 80GB HBM3' or "
                               "'cpu'")
        kind = torch.cuda.get_device_name()
    low = kind.lower()
    for sub, (hbm, rates) in DEVICE_PEAKS.items():
        if sub in low:
            if dtype not in rates:
                raise ValueError(f"no {dtype} peak for {kind!r}; it has "
                                 f"{sorted(rates)}")
            return rates[dtype], hbm
    raise ValueError(f"no peaks for device kind {kind!r}; known kinds "
                     f"contain one of {sorted(DEVICE_PEAKS)}")


def bound_ms(nbytes: float, ops: float,
             peak: float = F32_FLOPS) -> Tuple[float, str]:
    """(the least ms of moving `nbytes` and issuing `ops` at `peak` a
    second on the H100, "bytes" or "operations": which of the two)."""
    b, f = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return max(b, f), ("bytes" if b >= f else "operations")


class Work(NamedTuple):
    """What one call must do: bytes moved, operations issued, and the
    peak rate a second of those operations' type."""
    nbytes: float
    ops: float
    peak: float = F32_FLOPS

    def bound(self) -> Tuple[float, str]:
        """`bound_ms` of this work: (ms, "bytes" or "operations")."""
        return bound_ms(self.nbytes, self.ops, self.peak)

    def ops_ms(self) -> float:
        """The operations alone at their peak, in ms."""
        return self.ops / self.peak * 1e3


# ------------------------------------------------------------------ build
def summarize_work(n: int, L: int, w: int, elem_bytes: int = 4) -> Work:
    """`summarize` (repro's kernel interface, no z-norm) over (n, L): the
    series read once, the (n, w) PAA (float32) and symbols (int32)
    written once; one add a value at the issue rate."""
    return Work(n * L * elem_bytes + n * w * 8, n * L, F32_ISSUE)


def summarize_rows_work(n: int, L: int, w: int,
                        elem_bytes: int = 4) -> Work:
    """`summarize_rows` (what the build launches) over raw (n, L): raw
    read once; the float32 series, PAA, int32 symbols and norms written
    once; six float32 instructions a value (the mean's add, the
    deviation's subtract and FMA, the scaling's subtract and multiply,
    the norm's FMA) at the issue rate."""
    return Work(n * L * elem_bytes + n * L * 4 + n * w * 8 + n * 4,
                n * L * 6, F32_ISSUE)


def leaf_stats_work(n: int, w: int, M: int) -> Work:
    """`leaf_stats` over n rows in leaves of M: each row's order entry
    (int64), PAA (float32) and symbols (uint8) read once; each leaf's
    two edges and flag written once; min, max and a lookup a value, four
    instructions, at the issue rate."""
    return Work(n * (8 + w * 4 + w) + n // M * (w * 8 + 1), n * w * 4,
                F32_ISSUE)


def leaf_gather_work(rows: int, L: int, w: int,
                     elem_bytes: int = 4) -> Work:
    """`leaf_gather` of `rows` rows: each row's series, PAA, symbols and
    norm read once with its int64 order entry, and written once with
    its int32 id; no arithmetic."""
    row = L * elem_bytes + w * 4 + w + 4
    return Work(rows * (row + 8) + rows * (row + 4), 0)


# ----------------------------------------------------------------- search
def lb_distance_work(nq: int, nl: int, w: int) -> Work:
    """`lb_distance` of nq queries against nl leaf regions: the PAA and
    both edges read once, the (nq, nl) float32 bounds written once; five
    float32 instructions a (query, leaf, segment) term (two subtracts,
    two max, one FMA, none of them counted as two flops) at the issue
    rate."""
    return Work(nq * nl * 4 + (nq + 2 * nl) * w * 4, nq * nl * w * 5,
                F32_ISSUE)


def refine_topk_work(nq: int, K: int, M: int, L: int, k: int, alive: int,
                     elem_bytes: int = 4) -> Work:
    """One `refine_topk` round of nq queries, K slots each, `alive` of
    them alive: each alive leaf's M rows and their norms read once; each
    query, its norm, its K slot ids and flags (5 bytes a slot) and its
    (k,) buffer read and written once; a multiply-add a value of every
    alive row (2 flops) at the float32 FMA rate."""
    return Work(alive * M * (L * elem_bytes + 4)
                + nq * (L * 4 + 4 + K * 5 + k * 16),
                alive * M * L * 2, F32_FLOPS)


class SearchWork(NamedTuple):
    """`search_work`'s two byte counts.  `work` is the bound: every leaf
    alive for any query read once (`leaves` of them), since one read can
    serve every query alive on it.  `own_leaf_bytes` is the leaf bytes
    when each query reads its own alive leaves, as `refine_search` does
    today; it is the kernel's traffic, not the least the card needs."""
    work: Work
    leaves: int
    own_leaf_bytes: int


def search_work(order: torch.Tensor, rounds: torch.Tensor,
                alive: torch.Tensor, *, M: int, L: int, elem_bytes: int,
                K: int, k: int) -> SearchWork:
    """The refinement of a search (`refine_search`): `order` is each
    query's queue of leaves (Q, slots), `rounds` and `alive` each
    query's rounds and alive slots.  A query's alive slots are the first
    `alive` entries of its queue (the queue ascends, the k-th best never
    grows).  Each alive leaf is M rows at the stored width and their
    norms; besides, each query's queue entries of the rounds it ran (id
    and bound, 8 bytes), the queries, their norms and the buffers.  The
    flops are those of every alive (query, leaf row) pair."""
    leaf_bytes = M * (L * elem_bytes + 4)
    cols = torch.arange(order.shape[1], device=order.device)
    leaves = int(order[cols < alive[:, None].long()].unique().numel())
    slots = int(alive.sum())
    nbytes = (leaves * leaf_bytes + int(rounds.sum()) * K * 8
              + order.shape[0] * (L * 4 + 4 + k * 8))
    return SearchWork(Work(nbytes, slots * M * L * 2, F32_FLOPS), leaves,
                      slots * leaf_bytes)


def ed_argmin_work(nq: int, n: int, L: int, elem_bytes: int = 4) -> Work:
    """The exact 1-NN scan of nq queries over n rows stored in float32
    (elem_bytes 4) or bfloat16 (2): the rows, the queries and the (nq,)
    answers moved once.  The products at the check's accuracy on the
    tensor cores, every route's: three TF32 products a term for float32
    rows (3xTF32), 6 nq n L operations at the tf32 rate, and two for
    bfloat16 rows, which are exact in TF32, 4 nq n L."""
    nbytes = n * L * elem_bytes + nq * L * 4 + nq * 8
    products = 3 if elem_bytes == 4 else 2
    return Work(nbytes, 2 * products * nq * n * L, TF32_FLOPS)


# -------------------------------------------------------------- attention
def attention_pairs(T: int, S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the attention computes: the visible ones, and
    all S keys for a row that sees none (it averages V)."""
    total = 0
    for t in range(T):
        lo = max(t - window + 1, 0) if window else 0
        hi = min(t, S - 1) if causal else S - 1
        seen = hi - lo + 1
        total += seen if seen > 0 else S
    return total


def flash_attention_work(B: int, Hq: int, Hkv: int, T: int, S: int,
                         dh: int, causal: bool = True, window: int = 0,
                         elem_bytes: int = 2) -> Work:
    """`flash_attention` in bf16 (elem_bytes 2) or float32 (4): q, k, v
    read and the output written once; 4 dh flops a computed (query, key)
    pair (Q.K and P.V) a query head at the bf16 tensor-core rate.  The
    float32 products at the check's accuracy on the tensor cores, as
    `ed_argmin_work` counts float32 rows: three TF32 products a term
    (3xTF32), 12 dh flops a pair at the tf32 rate."""
    nbytes = elem_bytes * (2 * B * Hq * T * dh + 2 * B * Hkv * S * dh)
    flops = 4 * dh * attention_pairs(T, S, causal, window) * B * Hq
    if elem_bytes == 2:
        return Work(nbytes, flops, BF16_FLOPS)
    return Work(nbytes, 3 * flops, TF32_FLOPS)


def flash_attention_floors(work: Work, chunks: int = 1) -> Dict[str, float]:
    """The kernel's own floors beside its bound: P.V runs twice (P_hi,
    P_lo), 6 dh flops a pair where the bound counts 4, on the tensor
    cores; and the same products as float32 FMAs.  Where O is computed in
    `chunks` chunks of columns (past dh 512), each chunk's blocks compute
    the scores again: `route_floor_ms` counts the scores once a chunk at
    the work's type, 2 dh (chunks + 2) flops a pair in bf16 (P.V twice),
    6 dh (chunks + 1) in 3xTF32 (three products a term each)."""
    out = {"tensor_floor_ms": 1.5 * work.ops / BF16_FLOPS * 1e3,
           "f32_fma_floor_ms": work.ops / F32_FLOPS * 1e3}
    if chunks > 1:
        factor = ((chunks + 2) if work.peak == BF16_FLOPS else chunks + 1) / 2
        out["route_floor_ms"] = factor * work.ops_ms()
    return out


# -------------------------------------------------------------------- dtw
def lb_keogh_work(nq: int, n: int, L: int) -> Work:
    """`dtw_lb_keogh` of nq queries over n series: the series, the
    queries and the (nq, n) bounds moved once; four float32 instructions
    a point a query, the fewest it needs (a max, a min, a subtract and
    an FMA: e = x - min(max(x, lo), hi)), at the issue rate."""
    return Work(4 * (n * L + nq * L + nq * n), nq * n * L * 4, F32_ISSUE)


def dtw_cells(L: int, r: int) -> int:
    """The band cells of one (query, series) pair: row i spans columns
    max(0, i - r) .. min(L - 1, i + r)."""
    return sum(min(L - 1, i + r) - max(0, i - r) + 1 for i in range(L))


def dtw_scan_work(nq: int, n: int, L: int, r: int) -> Work:
    """`dtw_scan`, the brute force of nq queries over n series: the
    series and the queries read once; every band cell of every pair (the
    scan abandons none), five float32 instructions a cell (subtract,
    multiply, two mins, add; the multiply and the add kept apart) at the
    issue rate."""
    return Work(4 * (n + nq) * L, nq * n * dtw_cells(L, r) * 5, F32_ISSUE)


def dtw_search_work(cells: int, refined: int, L: int, rounds: int,
                    round_k: int) -> Work:
    """`dtw_search`, a group's refinement: the `refined` candidates' rows
    read once and each round's `round_k` queue entries (bound, id, and
    the candidate's slot: 12 bytes) of the `rounds` the group's queries
    ran in all; `cells` DP cells (the caller counts those an abandoning
    DP needs), five float32 instructions each at the issue rate."""
    return Work(4 * refined * L + 12 * rounds * round_k, cells * 5,
                F32_ISSUE)


def wave_step_cells(L: int, r: int, cells: int) -> torch.Tensor:
    """The band cells that `dtw_search`'s wavefront (`cells` a lane)
    forms at each of its L + r // cells steps: lane l forms row s - l's
    offsets cells * l + m at step s.  (steps,) int64."""
    H, l0 = -(-(2 * r + 1) // cells), r // cells
    s = torch.arange(L + l0)[:, None, None]
    ll = torch.arange(H)[None, :, None]
    m = torch.arange(cells)[None, None, :]
    i, k, c = s - ll, cells * ll + m, s + (cells - 1) * ll - r + m
    inside = (i >= 0) & (i < L) & (k <= 2 * r) & (c >= 0) & (c < L)
    return inside.sum((1, 2))


# ------------------------------------------------ repro's analytic roofline
@dataclass
class Roofline:
    """repro's roofline record, field for field.  `xla_flops` and
    `xla_bytes` are XLA's raw cost analysis in repro; nothing fills them
    in the port, which compiles no XLA."""
    flops: float                  # per device
    bytes_hbm: float              # per device
    bytes_coll: float             # per device
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    model_flops: Optional[float] = None
    useful_ratio: Optional[float] = None
    coll_by_kind: Dict[str, int] = field(default_factory=dict)
    xla_flops: Optional[float] = None
    xla_bytes: Optional[float] = None

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in
                ("flops", "bytes_hbm", "bytes_coll", "t_compute", "t_memory",
                 "t_collective", "dominant", "model_flops", "useful_ratio",
                 "coll_by_kind", "xla_flops", "xla_bytes")}


def model_flops_for(cfg, shape) -> float:
    """6*N_active*D tokens rule (train) / 2*N_active*D (fwd-only)."""
    counts = cfg.param_counts()
    n_active = counts["active"]
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6 if shape.kind == "train" else 2
    return mult * n_active * tokens


def refine_analytic(Q: int, K: int, M: int, L: int, k: int,
                    dtype_bytes: int = 4) -> Dict[str, float]:
    """repro's analytic cost of ONE refine round, every slot alive:
    flops, and HBM bytes for the fused kernel (each (M, L) leaf block
    streamed once) and for a path that writes the gather out and reads
    it back.  `refine_topk_work` is the port's count of a round with
    only some slots alive."""
    flops = 2.0 * Q * K * M * L
    leaf = float(dtype_bytes) * Q * K * M * L     # gathered member rows
    small = 4.0 * Q * L + 12.0 * Q * k            # queries + BSF buffers
    return {"flops": flops,
            "bytes_fused": leaf + small,
            "bytes_mat": 3.0 * leaf + small}


def roofline_fraction(seconds: float, *, Q: int, K: int, M: int, L: int,
                      k: int, dtype_bytes: int = 4,
                      kind: Optional[str] = None) -> float:
    """The share of the roofline one measured refine round, every slot
    alive, reached: max(t_compute, t_memory) / seconds over
    `refine_analytic`'s fused terms and `device_peaks(kind)`, repro's
    peaks.  The port's refine computes in float32, but the bytes term
    dominates at every refine shape (~0.5 flop a byte, against a ridge
    of 20 even at the H100's float32 rate), so the bf16 peak gives the
    same fraction.  1.0 = as fast as the roofline allows."""
    if seconds <= 0:
        raise ValueError(f"seconds must be > 0, got {seconds}")
    peak_flops, hbm_bw = device_peaks(kind)
    a = refine_analytic(Q, K, M, L, k, dtype_bytes)
    bound = max(a["flops"] / peak_flops, a["bytes_fused"] / hbm_bw)
    return bound / seconds
