"""Exact DTW search under a Sakoe-Chiba band: LB_Keogh, the refinement
of a search, and the brute-force scan.

On CUDA tensors `lb_keogh`, `dtw_search` and `dtw_scan` launch the
kernels of `csrc/dtw.cu` (and `csrc/dtw_ring.cu`, the scan's wider ring
instances; port-side sources with no Pallas original:
repro's DTW is plain jnp), by the routes `lb_route`, `dp_route` and
`scan_route` pick from the shapes, or by another route that takes the
shape where the caller asks; on CPU tensors they run the plain versions
`ref.lb_keogh_ref`, `ref.dtw_search_ref` and `ref.dtw_scan_ref`.  On any
other device they raise.  Each takes a band radius r >= L - 1 as L - 1
(the band then holds every column of every row: the same cells, the
same bits), so every radius has a route.  `launches` counts the
kernels' launches, `by_route` those of each (kernel, route).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .ref import dtw_scan_ref, dtw_search_ref, lb_keogh_ref

launches = 0
by_route: dict = {}                    # launches of each "kernel/route"

WHOLE_L = 1024         # the longest series the wave routes stage whole
MAX_BAND_R = 16                        # dtw_scan's band route's largest r
# dtw_search's wave routes: cells a lane, and the largest radius each takes
# (2r + 1 offsets over at most 32 lanes)
WAVE_CELLS = {"wave2": 2, "wave4": 4, "wave8": 8}
WAVE_MAX_R = {name: (32 * c - 1) // 2 for name, c in WAVE_CELLS.items()}
# the same lanes for L > WHOLE_L, each pair's series through a ring of
# columns that the warp refills as the front advances (ring_size), and
# ring16 (16 cells a lane, r <= 255) there too
RING_CELLS = {"ring2": 2, "ring4": 4, "ring8": 8, "ring16": 16}
RING_MAX_R = {name: (32 * c - 1) // 2 for name, c in RING_CELLS.items()}
MAX_ROUND_K = 1024     # the wave routes' round
# dtw_scan's wave route, the same lane layout at 16 cells a lane, for 16 <
# r <= 255: of 4, 8 and 16 cells a lane, 16 spent the fewest issue slots a
# cell on an H100 at r 25 and 102 (PERF.md, the table of cells a lane)
SCAN_CELLS = {"wave16": 16}
SCAN_MAX_R = {name: (32 * c - 1) // 2 for name, c in SCAN_CELLS.items()}
# the same for L > WHOLE_L, the series through rings, at cells a lane
# chosen by radius (scan_ring_cells): each width takes every r <= 255
SCAN_RING_WIDTHS = (16, 18, 20, 22, 24)
SCAN_RING_CELLS = {f"ring{c}": c for c in SCAN_RING_WIDTHS}
RING_CHUNK = 32                        # columns a ring fill copies
STAGE_L = 16384        # the longest query a kernel stages in shared memory
GROUP = 32                             # queries of one lb_keogh launch
_SMEM = 200 * 1024                     # shared memory a block may ask for
_SCAN_BAND_THREADS = 128
_SCAN_WAVE_WARPS = 16                  # the scan wave route's CTA, at most

_LB_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2)
_SEARCH_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                    + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 8)
_SCAN_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                  + [ctypes.c_int] * 14 + [ctypes.c_void_p] * 3)
_CHAIN_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)
_SPREAD_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                    + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 7
                    + [ctypes.c_longlong] + [ctypes.c_void_p] * 2)
# the diag routes (csrc/dtw.cu strip_dp): the rows a lane built, the
# scan's CTA (8 warps), the pairs in flight at most, and the device
# scratch a launch's strip rows may take (beyond one pair a query)
DIAG_ROWS = (4, 8)
_DIAG_SCAN_THREADS = 256
_DIAG_SLOTS = 4096
_DIAG_SCRATCH = 256 << 20
# the chain and spread routes (csrc/dtw.cu scan_chain, search_spread): the
# strips of the diag routes with every pair's rows in one CTA's shared
# memory.  The scan's CTA (8 warps, a warp's row of floats each); the
# search's (16 warps, one an SM, as many pairs in flight at most); and the
# rounds an iteration of the search computes at once, at most (as the wave
# routes' kSpec)
_CHAIN_THREADS = 256
_SPREAD_WARPS = 16
SPEC = 8
# dtw_scan's chain route (a warp a pair) is the default past r 255 from
# 1,024 pairs, about half the warps an H100 holds: on fewer, most of the
# card waits on a few chains, and the diag route (a pair's strips on many
# warps) is faster (chip_smoke.py's dtw_wide phase times both)
CHAIN_PAIRS = 1024
# a wave or ring route's code: its cells a lane (the kernel takes the ring
# where L > WHOLE_L)
_DP_CODES = {"diag": 1, **WAVE_CELLS, **RING_CELLS}
_SCAN_CODES = {"band": 0, "diag": 2, **SCAN_CELLS, **SCAN_RING_CELLS}
_LB_CODES = {"vec": 0, "scalar": 1}


def lb_route(L: int, aligned: bool = True) -> str:
    """"vec" where L % 4 == 0 and the collection is 16-byte aligned (a
    lane reads 4 points of a series with one 16-byte load), "scalar" for
    every other L (four 4-byte loads).  Both are one kernel: a lane owns
    4 whole series, each (query, series) sum in a register."""
    return "vec" if L % 4 == 0 and aligned else "scalar"


def dp_route(r: int, L: int = 256, round_k: int = 32) -> str:
    """dtw_search's route for band radius r, length L and round_k:
    "wave2", "wave4" and "wave8" for r <= 31, 63 and 127 (a pair's band
    swept as a wavefront over ceil((2r + 1) / cells) lanes of a warp, 2,
    4 and 8 cells a lane, r a runtime argument, each pair abandoned once
    it cannot win, its series staged whole), "ring2", "ring4", "ring8"
    and "ring16" for r <= 31, 63, 127 and 255 at L > 1024 (the series
    through a ring of columns); "spread" for the rest or round_k > 1024
    (strips of rows, a round's strips spread over a query's CTAs, a
    pair's rows handed on in its CTA's shared memory, spec rounds at
    once); "diag" where a pair's row passes shared memory (spread_fits:
    the same strips, their rows in device scratch)."""
    if round_k <= MAX_ROUND_K:
        names = WAVE_MAX_R if L <= WHOLE_L else RING_MAX_R
        for name, top in names.items():
            if r <= top:
                return name
    return "spread" if spread_fits(L, r) else "diag"


def dp_routes(r: int, L: int = 256, round_k: int = 32) -> tuple:
    """Every route of dtw_search that takes band radius r at length L
    and round_k: its default first, then "spread" where a pair's row
    fits shared memory, then "diag" (any shape)."""
    rest = (("spread",) if spread_fits(L, r) else ()) + ("diag",)
    first = dp_route(r, L, round_k)
    return (first,) + tuple(n for n in rest if n != first)


def scan_lanes(r: int, cells: int) -> Tuple[int, int]:
    """(lanes a pair H = ceil((2r + 1) / cells), pairs a warp P = 32 //
    H) of dtw_scan's wave and ring routes: H P of a warp's 32 lanes
    are busy."""
    H = -(-(2 * r + 1) // cells)
    return H, 32 // H


def scan_ring_cells(r: int) -> int:
    """The cells a lane C of dtw_scan's ring route at band radius r (17 <=
    r <= 255 on the default route): of SCAN_RING_WIDTHS, the one that puts
    the largest share of a warp's lane cells on band cells, P (2r + 1) /
    (32 C) (H, P = scan_lanes(r, C)), the narrowest on ties.  A cell
    takes the same instructions at every width, so the share sets the
    route's speed: idle lanes and the top lane's cells past the band both
    lower it.  At 16 alone it was 0.79 on average over r 17-255 and 0.50
    at worst, 120 radii leaving 5 or more lanes idle (r 135: H 17, P 1);
    with the widths to 24 it is 0.92 on average and 0.75 at worst, at
    least 25 lanes busy at every radius (r 135: 18 cells, H 16, P 2; r
    81: 22 cells, H 8, P 4)."""
    def share(c):
        H, P = scan_lanes(r, c)
        return P * (2 * r + 1) / (32 * c)
    return max(SCAN_RING_WIDTHS, key=lambda c: (share(c), -c))


def scan_route(r: int, L: int = 256, Q: int | None = None,
               N: int | None = None) -> str:
    """dtw_scan's route for band radius r (at most L - 1), length L and Q
    queries over N series (None: many): "band" for r <= 16 (a thread a
    pair, the previous row's band in registers, one template instance a
    radius), "wave16" for r <= 255 (each pair's band a wavefront over the
    lanes of a warp, 16 cells a lane, r a runtime argument), "ring<c>"
    for the same radii at L > 1024 (the series through a ring of columns,
    the queries read from device memory; c = scan_ring_cells(r) cells a
    lane); beyond, "chain" from CHAIN_PAIRS pairs Q N where a warp's row
    fits beside 8 (chain_fits: strips of rows, a warp a pair, its rows
    handed on in the warp's shared memory), else "diag" (the same strips
    spread over the whole card, their rows in device scratch)."""
    if r <= MAX_BAND_R:
        return "band"
    if r > SCAN_MAX_R["wave16"]:
        many = Q is None or N is None or Q * N >= CHAIN_PAIRS
        return "chain" if many and chain_fits(L, r) else "diag"
    return "wave16" if L <= WHOLE_L else f"ring{scan_ring_cells(r)}"


def scan_routes(r: int, L: int = 256, Q: int | None = None,
                N: int | None = None) -> tuple:
    """Every route of dtw_scan that takes band radius r at length L (Q
    queries over N series): its default first, then the wave route (L <=
    1024) or every ring width (above) where the lanes hold the band,
    "chain" where a warp's row fits, then "diag" (any r)."""
    wave = () if r > SCAN_MAX_R["wave16"] else (
        ("wave16",) if L <= WHOLE_L else tuple(SCAN_RING_CELLS))
    rest = ((("band",) if r <= MAX_BAND_R else ()) + wave
            + (("chain",) if chain_fits(L, r) else ()) + ("diag",))
    first = scan_route(r, L, Q, N)
    return (first,) + tuple(n for n in rest if n != first)


def ring_size(cells: int, lanes: int) -> int:
    """Floats of a pair's ring on a ring route (csrc/dtw.cu ring_size): the
    least power of two of at least span + 2 RING_CHUNK + 8, where a step's
    lanes read span = (cells - 1)(lanes - 1) + cells columns."""
    need = (cells - 1) * (lanes - 1) + cells + 2 * RING_CHUNK + 8
    return 1 << (need - 1).bit_length()


def scan_geometry(L: int, r: int, cells: int, Q: int) -> dict:
    """The launch of dtw_scan's wave route at `cells` a lane (see
    csrc/dtw.cu, scan_wave_kernel), in floats but for smem (bytes).

    A pair takes H = ceil((2r + 1) / cells) lanes, a warp P = 32 // H
    pairs: one series each, staged in the warp's tile, the P rows `stride`
    apart after `pad` floats, the gaps (and the pad) filled with a value
    whose squared difference from any query value overflows, so a cell
    past a row's ends is no cheaper than BIG: a lane's cell m at its step
    j reads column j + l0 + (cells - 1) ll - r + m, from r - l0 before the
    row to l0 + cells H - H - r past it.  The row stride is stride = shift
    mod 32 floats (shift = 32 / the power of two >= P, at least 4), so the
    pairs' lanes read apart banks.  The queries of a chunk sit in rows of
    `qstride` floats, each row at offset H, read from index l0 - (H - 1)
    to l0 + L - 1 (the ends filled likewise).  `queries` (at most 32) a
    chunk and `threads` (16 warps at most) a CTA share `_SMEM` bytes,
    with 8 warps kept where the tiles allow.  The launch may take the
    chunks smaller (where the collection's tiles are too few to fill the
    card, so that its CTAs share more (chunk, tiles) units), which only
    frees shared memory.

    At L > 1024 (the "ring<cells>" routes) a pair's series goes through
    a ring of `stride` = ring_size(cells, H) floats in place of a row, and
    the queries are read from device memory: pad and qstride are 0, and
    the CTA's warps (16 at most, fewer where their P rings each pass
    `_SMEM` bytes: 8 at r <= 3) hold P rings each."""
    H, P = scan_lanes(r, cells)
    l0 = r // cells
    if L > WHOLE_L:
        W = ring_size(cells, H)
        warps = min(_SCAN_WAVE_WARPS, _SMEM // (4 * P * W))
        return {"lanes": H, "pairs": P, "pad": 0, "stride": W,
                "qstride": 0, "queries": max(1, min(Q, 32)),
                "threads": 32 * warps, "smem": 4 * warps * P * W}
    pad = -(-max(r - l0, l0 + cells * H - H - r, 0) // 4) * 4
    shift = max(4, 32 >> (P - 1).bit_length())
    stride = L + pad + (shift - (L + pad)) % 32
    tile = pad + P * stride
    qstride = -(-(H + L + l0) // 4) * 4
    budget = _SMEM // 4
    aim = max(1, min(8, (budget - qstride) // tile))
    queries = max(1, min(Q, 32, (budget - aim * tile) // qstride))
    warps = min(_SCAN_WAVE_WARPS, (budget - queries * qstride) // tile)
    return {"lanes": H, "pairs": P, "pad": pad, "stride": stride,
            "qstride": qstride, "queries": queries, "threads": 32 * warps,
            "smem": 4 * (queries * qstride + warps * tile)}


def diag_rows(r: int) -> int:
    """Rows a lane of the diag routes at band radius r (a strip is 32 of
    them a warp): 4 to r 255, 8 beyond.  More rows a lane share a step's
    shuffles and load among more cells but lengthen its chain of dependent
    cells; and a strip of S rows sweeps min(L, 2r + S) + 31 steps for its
    S (2r + 1) band cells at most, so a narrow band wants short strips."""
    return 4 if r <= 255 else 8


def diag_strips(L: int, rows: int) -> int:
    """Strips a pair of length L at `rows` rows a lane: ceil(L / 32 rows)."""
    return -(-L // (32 * rows))


def diag_width(L: int, r: int, rows: int) -> int:
    """Entries of a strip's last row: its columns, at most min(L, 2r + 32
    rows).  A strip stores no step past its last column: where the strip
    below starts at the same column, those entries are its own."""
    return min(L, 2 * r + 32 * rows)


def diag_chain(L: int, r: int, rows: int) -> int:
    """Strips a ticket of dtw_scan's diag route (a chain, one warp running
    them in order): all of a pair's where a strip overlaps the next for
    less than half its steps (min(L, 2r + S) + 31 steps against S + 94, the
    lag at which the strip below can run beside it; S = 32 rows), else 1,
    each strip on its own warp as soon as the one above is far enough
    ahead.  dtw_search takes 1 always: a round's few pairs need their
    strips spread over the cluster's warps."""
    S = 32 * rows
    thin = min(L, 2 * r + S) + 31 <= 2 * (S + 94)
    return diag_strips(L, rows) if thin else 1


def _diag_slots(pairs: int, width: int, budget: int) -> int:
    """Pairs in flight: each a slot of a strip row of `width` 8-byte
    entries and a done count, at most _DIAG_SLOTS and within `budget`
    bytes (one at least)."""
    return max(1, min(pairs, _DIAG_SLOTS, budget // (8 * width + 8)))


def diag_scan_geometry(Q: int, N: int, L: int, r: int) -> dict:
    """The launch of dtw_scan's diag route (csrc/dtw.cu scan_strips): rows
    a lane, strips a pair, `chain` strips a ticket (diag_chain), `width`
    entries a strip row, `slots` pairs in flight (batches of as many
    pairs, chain-major: `tickets` chains in all), and the scratch: a
    ticket, a done count a slot and each slot's row, `entries` 8-byte
    entries (`bytes`), zeroed."""
    rows = diag_rows(r)
    strips = diag_strips(L, rows)
    chain = diag_chain(L, r, rows)
    width = diag_width(L, r, rows)
    slots = _diag_slots(Q * N, width, _DIAG_SCRATCH)
    entries = 1 + slots + slots * width
    return {"rows": rows, "strips": strips, "width": width, "chain": chain,
            "slots": slots, "tickets": Q * N * -(-strips // chain),
            "entries": entries, "bytes": 8 * entries}


def diag_grid(tickets: int, held: int) -> int:
    """CTAs of dtw_scan's diag route: as many as the card holds at once
    (`held`, from the card), no more than the strips' warps need (8 a
    CTA), one at least."""
    warps = _DIAG_SCAN_THREADS // 32
    return max(1, min(held, -(-tickets // warps)))


def diag_search_geometry(Qg: int, N: int, L: int, r: int,
                         round_k: int) -> dict:
    """The launch of dtw_search's diag route (csrc/dtw.cu search_strips):
    rows a lane, strips a pair (a strip a ticket: a round's few pairs
    need their strips spread over the cluster's warps),
    `width` entries a strip row, `slots` pairs of a round in flight a query
    (the Qg queries' scratch within _DIAG_SCRATCH bytes), and a query's
    scratch, `per_query` 8-byte entries: the ticket, the count taken, two
    round keys, a done count a slot, the round's list (min(round_k, N))
    and each slot's row; `bytes` in all, zeroed."""
    rows = diag_rows(r)
    width = diag_width(L, r, rows)
    listed = min(round_k, N)
    slots = _diag_slots(listed, width, _DIAG_SCRATCH // max(Qg, 1))
    per_query = 4 + slots + listed + slots * width
    return {"rows": rows, "strips": diag_strips(L, rows), "width": width,
            "slots": slots, "per_query": per_query,
            "bytes": 8 * Qg * per_query}


def diag_cluster(held16: int, held8: int) -> int:
    """CTAs a query of dtw_search's diag route: 16 where the card holds a
    cluster of 16 (a non-portable size; `held16`, from the card), else 8.
    Raises RuntimeError where it holds neither."""
    if held16 > 0:
        return 16
    if held8 > 0:
        return 8
    raise RuntimeError("dtw_search diag: the card holds no cluster of 8 "
                       "CTAs of 512 threads")


def chain_fits(L: int, r: int) -> bool:
    """Whether dtw_scan's chain route takes (L, r): a warp's row of
    diag_width floats, 8 warps a CTA, within `_SMEM` bytes (every r to L
    6,400; r <= 3,072 at any L)."""
    w = diag_width(L, r, diag_rows(r))
    return 4 * (_CHAIN_THREADS // 32) * w <= _SMEM


def chain_scan_geometry(L: int, r: int) -> dict:
    """The launch of dtw_scan's chain route (csrc/dtw.cu scan_chain): rows
    a lane, strips a pair (one warp runs them all), `width` floats a
    warp's row, the CTA's threads and shared memory (bytes)."""
    rows = diag_rows(r)
    width = diag_width(L, r, rows)
    return {"rows": rows, "strips": diag_strips(L, rows), "width": width,
            "threads": _CHAIN_THREADS,
            "smem": 4 * (_CHAIN_THREADS // 32) * width}


def spread_fits(L: int, r: int) -> bool:
    """Whether dtw_search's spread route takes (L, r): one pair's row of
    diag_width 8-byte entries within `_SMEM` bytes (every r to L 25,600;
    r <= 12,672 at any L)."""
    return 8 * diag_width(L, r, diag_rows(r)) <= _SMEM


def spread_spec(N: int, round_k: int) -> int:
    """Rounds an iteration of dtw_search's spread route computes at once:
    SPEC, or the search's rounds where fewer.  Each iteration takes every
    candidate of its window below the best-so-far of its start, so a
    later round's candidates that a lower best-so-far would prune run
    too; in return a round of few pairs (the full window's 4 queries at
    round_k 32) no longer leaves most of the card idle."""
    return max(1, min(SPEC, -(-N // round_k)))


def spread_search_geometry(Qg: int, N: int, L: int, r: int,
                           round_k: int) -> dict:
    """The launch of dtw_search's spread route (csrc/dtw.cu
    search_spread): rows a lane, strips a pair (each a ticket: a round's
    strips spread over the warps), `spec` rounds an iteration
    (spread_spec), `width` entries a strip row, `slots` pairs in flight a
    CTA (16, its warps, fewer where their rows pass `_SMEM` bytes) and its
    shared memory (bytes), and the scratch: `wdist` floats a query's row
    of distances (two a query, by iteration parity) and a barrier count a
    query."""
    rows = diag_rows(r)
    strips = diag_strips(L, rows)
    width = diag_width(L, r, rows)
    slots = max(1, min(_SPREAD_WARPS, _SMEM // (8 * width)))
    spec = spread_spec(N, round_k)
    return {"rows": rows, "strips": strips, "spec": spec,
            "width": width, "slots": slots, "smem": 8 * slots * width,
            "wdist": max(1, min(spec * round_k, N))}


_DIAG_HELD: dict = {}


def _diag_held(device: torch.device, rows: int) -> Tuple[int, int, int]:
    """(scan CTAs, clusters of 16, clusters of 8) that `device` holds at
    once of the diag kernels at `rows` rows a lane (csrc/dtw.cu
    diag_held), asked once a device and width."""
    key = (device.index, rows)
    held = _DIAG_HELD.get(key)
    if held is None:
        fn = _build.entry("dtw", "dtw_diag_held",
                          [ctypes.c_int, ctypes.c_void_p])
        out = (ctypes.c_int * 3)()
        with torch.cuda.device(device):
            code = fn(rows, ctypes.addressof(out))
        _build.check("dtw", "dtw_diag_held", code)
        held = _DIAG_HELD[key] = tuple(out)
    return held


def wave_cells(route: str) -> int:
    """Cells a lane of one of dtw_search's wave or ring routes."""
    return {**WAVE_CELLS, **RING_CELLS}[route]


def band_threads(r: int, L: int, round_k: int, cells: int = 2) -> int:
    """Threads of each CTA of dtw_search's wave routes (a cluster of 8 a
    query, one round each): a pair takes H = ceil((2r + 1) / cells) lanes
    (r + 1 at 2 cells), a warp runs 32 // H pairs, each with its series
    in shared memory (whole to L 1024, else a ring of ring_size(cells, H)
    floats) beside the query (where L <= STAGE_L) and the round's
    distances and bounds (two of each a candidate); as many warps as a
    round's candidates need, at most 32 (16 at 16 cells a lane, whose
    lanes hold more registers), and at most as many as fit in `_SMEM`
    bytes (one at least: round_k <= 1024)."""
    H = -(-(2 * r + 1) // cells)
    P = 32 // H
    row = L if L <= WHOLE_L else ring_size(cells, H)
    qf = L if L <= STAGE_L else 0
    return 32 * min(32 if cells < 16 else 16, -(-round_k // P),
                    (_SMEM // 4 - qf - 4 * round_k) // (P * row))


def _pick(route, default: str, allowed: tuple, what: str) -> str:
    """The route a caller asked for (None: the default), if it takes the
    shape."""
    if route is None:
        return default
    if route not in allowed:
        raise ValueError(f"{what} takes the routes {allowed}, got {route!r}")
    return route


def lb_group(L: int) -> int:
    """Queries one lb_keogh launch takes: at most 32, a multiple of 8 (the
    kernel's query slots come in 8s), their envelopes ((lo, hi) a point,
    L rounded up to 4 points) within `_SMEM` bytes of shared memory: 32
    up to L 800, 24 to L 1024; 32 above, in column chunks (lb_chunk)."""
    if L > WHOLE_L:
        return GROUP
    Lp = -(-L // 4) * 4
    return max(8, min(GROUP, _SMEM // (8 * Lp)) // 8 * 8)


def lb_chunk(L: int) -> int:
    """Columns one lb_keogh launch sums: all L to L 1024; above, 800 (a
    multiple of 4, whose envelopes of 32 queries fill `_SMEM` bytes), each
    chunk's launch going on from the sums the last one stored, in the
    same order, so the bits are one pass's."""
    return L if L <= WHOLE_L else _SMEM // (8 * GROUP) // 4 * 4


def _count(kernel: str, route: str) -> None:
    global launches
    with _build.COUNT_LOCK:
        launches += 1
        key = f"{kernel}/{route}"
        by_route[key] = by_route.get(key, 0) + 1


def _check(q: torch.Tensor, x: torch.Tensor, r: int) -> int:
    """Raises on input no kernel takes; returns the band radius the
    kernels take, min(r, L - 1): a band of radius L - 1 already holds
    every column of every row, so a wider one reads the same cells with
    the same operands (and LB_Keogh's envelope is the same)."""
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"need q (Q, L) and x (N, L), got "
                         f"{tuple(q.shape)} and {tuple(x.shape)}")
    if q.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"q and x must be float32, got {q.dtype}, {x.dtype}")
    if not (q.is_contiguous() and x.is_contiguous()):
        raise ValueError("q and x must be contiguous")
    if q.device != x.device:
        raise ValueError("q and x must share a device")
    if q.shape[1] < 1:
        raise ValueError("series length must be at least 1")
    if not isinstance(r, int) or r < 0:
        raise ValueError(f"band radius r must be an int >= 0, got {r!r}")
    if q.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no DTW kernel for device {q.device}")
    return min(r, q.shape[1] - 1)


def lb_keogh(q: torch.Tensor, x: torch.Tensor, *, r: int,
             route: str | None = None) -> torch.Tensor:
    """The squared LB_Keogh of each query of q (Qg, L) against each series
    of x (N, L), band radius r: (Qg, N) float32, any L.  One launch for
    each `lb_group(L)` queries and `lb_chunk(L)` columns, each reading
    its columns of the collection once, by `route` (default
    `lb_route(L, x 16-byte aligned)`; "scalar" takes every L).

    Raises ValueError/TypeError on input the kernel does not take, and
    RuntimeError if a launch fails."""
    r = _check(q, x, r)
    L = q.shape[1]
    default = lb_route(L, x.data_ptr() % 16 == 0)
    route = _pick(route, default, (default, "scalar"), "lb_keogh")
    if q.device.type == "cpu":
        return lb_keogh_ref(q, x, r)
    Qg, N = q.shape[0], x.shape[0]
    out = torch.empty((Qg, N), dtype=torch.float32, device=x.device)
    fn = _build.entry("dtw", "dtw_lb_keogh", _LB_ARGTYPES)
    step, chunk = lb_group(L), lb_chunk(L)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for g0 in range(0, Qg, step):
            n = min(step, Qg - g0)
            for j0 in range(0, L, chunk):
                code = fn(q[g0:].data_ptr(), x.data_ptr(), N, L, n, r,
                          _LB_CODES[route], j0, min(chunk, L - j0), j0 > 0,
                          out[g0:].data_ptr(), stream)
                _build.check("dtw", "dtw_lb_keogh", code)
                _count("lb_keogh", route)
    return out


def dtw_search(q: torch.Tensor, x: torch.Tensor, sorted_lb: torch.Tensor,
               order: torch.Tensor, *, r: int, round_k: int,
               route: str | None = None) -> Tuple[torch.Tensor, ...]:
    """The refinement of a DTW 1-NN search for each query of q (Qg, L)
    over x (N, L), in one launch: candidates order (Qg, N) int64 in the
    order of their ascending bounds sorted_lb (Qg, N) float32, round_k a
    round, the loop of rounds on the device, by `route` (default
    `dp_route(r, L, round_k)`; any of `dp_routes(r, L, round_k)`:
    "spread" takes every L, r and round_k whose row fits shared memory,
    "diag" every shape).  Returns (bsf
    (Qg,) float32 squared distances, best (Qg,) int32 ids, -1 where no
    candidate was taken, rounds (Qg,) int32, refined (Qg,) int32: the
    candidates whose DTW was computed), as `ref.dtw_search_ref`.

    Raises ValueError/TypeError on input the kernel does not take, and
    RuntimeError if the launch fails."""
    r = _check(q, x, r)
    Qg, L = q.shape
    N = x.shape[0]
    if sorted_lb.shape != (Qg, N) or order.shape != (Qg, N):
        raise ValueError(f"sorted_lb and order must be ({Qg}, {N}), got "
                         f"{tuple(sorted_lb.shape)}, {tuple(order.shape)}")
    if sorted_lb.dtype != torch.float32 or order.dtype != torch.int64:
        raise TypeError(f"need sorted_lb float32 and order int64, got "
                        f"{sorted_lb.dtype}, {order.dtype}")
    if not (sorted_lb.is_contiguous() and order.is_contiguous()):
        raise ValueError("sorted_lb and order must be contiguous")
    if sorted_lb.device != x.device or order.device != x.device:
        raise ValueError("sorted_lb and order must be on x's device")
    if not isinstance(round_k, int) or round_k < 1:
        raise ValueError(f"round_k must be an int >= 1, got {round_k!r}")
    routes = dp_routes(r, L, round_k)
    route = _pick(route, routes[0], routes, "dtw_search")
    if q.device.type == "cpu":
        return dtw_search_ref(q, x, sorted_lb, order, r, round_k)
    dev = x.device
    bsf = torch.empty((Qg,), dtype=torch.float32, device=dev)
    best, rounds, refined = (torch.empty((Qg,), dtype=torch.int32,
                                         device=dev) for _ in range(3))
    if Qg == 0:
        return bsf, best, rounds, refined
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "spread":
        # its geometry; two rows of distances a query, then a barrier count
        # a query (which the launch zeroes)
        g = spread_search_geometry(Qg, N, L, r, round_k)
        scratch = torch.empty((Qg * (2 * g["wdist"] + 1),),
                              dtype=torch.float32, device=dev)
        fn = _build.entry("dtw", "dtw_search_spread", _SPREAD_ARGTYPES)
        with torch.cuda.device(dev):
            code = fn(q.data_ptr(), x.data_ptr(), N, L, r, Qg, round_k,
                      g["rows"], g["spec"], g["slots"], g["width"],
                      sorted_lb.data_ptr(), order.data_ptr(),
                      bsf.data_ptr(), best.data_ptr(), rounds.data_ptr(),
                      refined.data_ptr(), scratch.data_ptr(), g["wdist"],
                      scratch.data_ptr() + 8 * Qg * g["wdist"], stream)
        _build.check("dtw", "dtw_search_spread", code)
        _count("dtw_search", route)
        return bsf, best, rounds, refined
    # the diag route takes its strips by its geometry, in zeroed scratch
    diag, dg, threads = None, (0, 0, 0, 0), 0
    if route == "diag":
        g = diag_search_geometry(Qg, N, L, r, round_k)
        dg = (g["rows"], g["slots"], g["width"],
              diag_cluster(*_diag_held(dev, g["rows"])[1:]))
        diag = torch.zeros((Qg, g["per_query"]), dtype=torch.int64,
                           device=dev)
    else:
        threads = band_threads(r, L, round_k, wave_cells(route))
    fn = _build.entry("dtw", "dtw_search", _SEARCH_ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(q.data_ptr(), x.data_ptr(), N, L, r, Qg, round_k, threads,
                  _DP_CODES[route], *dg, sorted_lb.data_ptr(),
                  order.data_ptr(), bsf.data_ptr(), best.data_ptr(),
                  rounds.data_ptr(), refined.data_ptr(),
                  diag.data_ptr() if diag is not None else None, stream)
    _build.check("dtw", "dtw_search", code)
    _count("dtw_search", route)
    return bsf, best, rounds, refined


def dtw_scan(q: torch.Tensor, x: torch.Tensor, *, r: int,
             route: str | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Banded DTW of each query of q (Q, L) against every series of x
    (N >= 1, L), in one launch, any Q and L: (the least squared distance
    (Q,) float32, its series (Q,) int32, the first on ties), by `route`
    (default `scan_route(r, L)`; any of `scan_routes(r, L)`: "diag"
    takes every r).  Every pair's whole band is computed: no pair is abandoned,
    so the scan stays independent of the search's lower bounds.

    Raises ValueError/TypeError on input the kernel does not take, and
    RuntimeError if the launch fails."""
    r = _check(q, x, r)
    Q, L = q.shape
    N = x.shape[0]
    if N == 0:
        raise ValueError("dtw_scan needs at least one series")
    if N >= 1 << 31:
        raise ValueError(f"dtw_scan takes N < 2^31, got {N}")
    routes = scan_routes(r, L, Q, N)
    route = _pick(route, routes[0], routes, "dtw_scan")
    if q.device.type == "cpu":
        return dtw_scan_ref(q, x, r)
    cells = {**SCAN_CELLS, **SCAN_RING_CELLS}.get(route)
    dev = x.device
    # all ones: above every (distance bits << 32 | series) key
    keys = torch.full((Q,), -1, dtype=torch.int64, device=dev)
    if Q and route == "chain":
        g = chain_scan_geometry(L, r)
        fn = _build.entry("dtw", "dtw_scan_chain", _CHAIN_ARGTYPES)
        with torch.cuda.device(dev):
            code = fn(q.data_ptr(), x.data_ptr(), N, L, r, Q, g["rows"],
                      g["width"], keys.data_ptr(),
                      torch.cuda.current_stream(dev).cuda_stream)
        _build.check("dtw", "dtw_scan_chain", code)
        _count("dtw_scan", route)
    elif Q:
        # the diag route: its strips by its geometry over as many CTAs as
        # the card holds, in zeroed scratch
        diag, dg = None, (0, 0, 0, 0, 0)
        if cells:
            g = scan_geometry(L, r, cells, Q)
            shape = (g["threads"], g["queries"], g["pad"], g["stride"],
                     g["qstride"])
        elif route == "diag":
            shape = (_DIAG_SCAN_THREADS, 0, 0, 0, 0)
            g = diag_scan_geometry(Q, N, L, r)
            dg = (g["rows"], g["slots"], g["width"], g["chain"],
                  diag_grid(g["tickets"], _diag_held(dev, g["rows"])[0]))
            diag = torch.zeros((g["entries"],), dtype=torch.int64,
                               device=dev)
        else:
            shape = (_SCAN_BAND_THREADS, 0, 0, 0, 0)
        # the ring route's wider forms are a library of their own
        # (csrc/dtw_ring.cu), built beside dtw.cu's
        src, name = (("dtw_ring", "dtw_scan_ring") if cells and cells > 16
                     else ("dtw", "dtw_scan"))
        fn = _build.entry(src, name, _SCAN_ARGTYPES)
        with torch.cuda.device(dev):
            code = fn(q.data_ptr(), x.data_ptr(), N, L, r, Q,
                      _SCAN_CODES[route], *shape, *dg, keys.data_ptr(),
                      diag.data_ptr() if diag is not None else None,
                      torch.cuda.current_stream(dev).cuda_stream)
        _build.check(src, name, code)
        _count("dtw_scan", route)
    d2 = (keys >> 32).to(torch.int32).view(torch.float32)
    return d2, (keys & 0xFFFFFFFF).to(torch.int32)
