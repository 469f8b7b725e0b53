"""Every shape repro takes gets a hand-written kernel route on the card.

Each wrapper picks its kernel's route from the shapes, before any launch,
through a pure function (`route`) that runs here without a card.  Over a
grid of (L, w, k, K, M, dtype) that repro accepts, every point gets a
route of the wrapper's own kernel and none raises; the main cell's shapes
keep the fast route they have always taken.  The plain versions take the
new shapes too, and agree with repro's: the port's search at L 96 and at
L 100 with w 10 (bf16 storage) answers repro's ids.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import FreshIndex as JFreshIndex
from repro.api import IndexConfig as JIndexConfig
from repro.kernels import ops as jops
from repro_torch.api import FreshIndex, IndexConfig
from repro_torch.kernels import (dtw, ed_argmin, flash_attention,
                                 isax_summarize, lb_distance, refine,
                                 refine_search)
from repro_torch.data.synthetic import query_workload, random_walk

torch.set_num_threads(2)

DTYPES = (torch.float32, torch.bfloat16)
LENGTHS = (25, 64, 90, 96, 100, 256, 384, 1000)
SEGMENTS = (1, 2, 4, 5, 8, 10, 16, 32)


def _shapes():
    for L, w in itertools.product(LENGTHS, SEGMENTS):
        if L % w == 0:
            yield L, w


@pytest.mark.parametrize("L,w", list(_shapes()))
def test_every_length_and_segment_count_has_a_route(L, w):
    for dtype in DTYPES:
        assert isax_summarize.route(L, w, dtype) in ("lanes", "strided")
    assert lb_distance.route(w) in ("tiled", "looped")
    for dtype, aligned in itertools.product(DTYPES, (True, False)):
        assert ed_argmin.route(L, dtype, aligned) in ed_argmin.ROUTES


@pytest.mark.parametrize("k", [1, 10, 4290, 5000, 14500, 20000])
@pytest.mark.parametrize("L", [25, 90, 96, 100, 256])
def test_every_refinement_shape_has_a_route(L, k):
    for dtype, K, M in itertools.product(
            DTYPES + (torch.float16,), (1, 3, 8, 64, 264), (1, 16, 64, 256)):
        r = refine.route(L, K, M, k, dtype)
        assert r in ("ring", "general")
        s = refine_search.route(L, K, M, k, dtype)
        assert s in refine_search.ROUTES
        elem = torch.finfo(dtype).bits // 8
        if r == "ring":
            # csrc's topk layout fits at 4, 3, 2 or 1 CTAs an SM
            assert (L * elem) % 16 == 0
            assert any(refine._fits(L, K, M, k, elem, b)
                       for b in (4, 3, 2, 1))
        if s != "general":
            # a cta route is laid out only where csrc's layout fits
            assert (L * elem) % 16 == 0
            assert refine_search._fits(L, K, M, k, elem, int(s[3:]))
        if (L * elem) % 16:
            assert r == s == "general"
        assert refine_search.general_words(K, M, k) >= 3 * K * M + 4 * k


def test_the_main_cell_keeps_the_fast_routes():
    for dtype in DTYPES:
        assert isax_summarize.route(256, 16, dtype) == "lanes"
        assert refine.route(256, 8, 64, 10, dtype) == "ring"
        assert refine_search.route(256, 8, 64, 10, dtype) == "cta3"
    assert lb_distance.route(16) == "tiled"
    assert ed_argmin.route(256) == "tensor"
    # the kernel phase's cluster cases stay on 3 CTAs an SM
    for M, K in ((16, 6), (32, 12), (64, 3), (8, 264)):
        assert refine_search.route(256, K, M, 10, torch.float32) == "cta3"
    # and every refine_topk case of the kernel phase takes the ring route
    for dtype, K, M in itertools.product(DTYPES, (8, 6, 12, 264),
                                         (16, 32, 64)):
        assert refine.route(256, K, M, 10, dtype) == "ring"


def test_the_faulting_shapes_take_the_other_routes():
    f32, bf16 = torch.float32, torch.bfloat16
    assert isax_summarize.route(96, 16, f32) == "strided"     # VPT 3
    assert isax_summarize.route(100, 10, f32) == "strided"
    assert isax_summarize.route(384, 16, f32) == "strided"    # VPT 12
    for w in (10, 12, 32):
        assert lb_distance.route(w) == "looped"
    assert refine.route(100, 8, 64, 10, bf16) == "general"    # 200 bytes
    assert refine.route(90, 8, 64, 10, f32) == "general"      # 360 bytes
    assert refine.route(256, 8, 64, 14500, f32) == "general"  # > 227 KB
    assert refine.route(256, 8, 64, 16000, f32) == "general"
    assert refine_search.route(100, 8, 64, 10, bf16) == "general"
    assert refine_search.route(256, 8, 64, 5000, f32) == "cta2"
    assert refine_search.route(256, 64, 256, 10, f32) == "cta1"
    assert refine_search.route(256, 8, 64, 20000, f32) == "general"
    # rows TMA cannot take go to the staged loader, never to a plain version
    assert ed_argmin.route(100) == "tensor"                   # 400 bytes
    assert ed_argmin.route(100, bf16) == "staged"             # 200 bytes
    assert ed_argmin.route(235) == "staged"                   # 940 bytes
    assert ed_argmin.route(256, f32, aligned=False) == "staged"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("aligned", [True, False])
def test_every_scan_length_takes_a_tensor_core_loader(dtype, aligned):
    """ed_argmin at every L from 1 to 600: TMA where a row is whole
    16-byte pieces on an aligned base, the staged cp.async loader
    otherwise; both feed the same tensor-core products, and no length
    falls to another route."""
    elem = torch.finfo(dtype).bits // 8
    for L in range(1, 601):
        r = ed_argmin.route(L, dtype, aligned)
        assert r in ed_argmin.ROUTES == ("tensor", "staged")
        assert (r == "tensor") == (aligned and (L * elem) % 16 == 0)


def test_refine_topk_ring_route_conditions():
    """The ring route: rows of whole 16-byte pieces, and csrc's topk layout
    (the fixed parts: 5 query rows, a window of 256 (row, slot) entries, a
    row's K * M distances and a fold's 256 candidates; then two stages
    of a leaf row at least) within a CTA's shared memory at 4, 3, 2 or 1
    CTAs an SM (fitting at more implies fitting at fewer).  Nothing else
    decides it: no launch, no device."""
    f32 = torch.float32
    # the main cell and the late-round case: 4 CTAs an SM (a leaf of 64
    # f32 rows of 256 is 64 KB, cut into stages of 16 rows)
    assert refine._fits(256, 8, 64, 10, 4, 4)
    for blocks in (1, 2, 3):
        for K, M, k in ((8, 64, 10), (264, 64, 10), (3, 256, 10),
                        (8, 64, 4290), (8, 64, 14500)):
            if refine._fits(256, K, M, k, 4, blocks + 1):
                assert refine._fits(256, K, M, k, 4, blocks)
    # 264 slots of 64 rows: 66 KB of distances beside a leaf's stages, two
    # CTAs an SM
    assert not refine._fits(256, 264, 64, 10, 4, 3)
    assert refine._fits(256, 264, 64, 10, 4, 2)
    assert refine.route(256, 264, 64, 10, f32) == "ring"
    # k grows the buffers past an SM: the general route
    assert refine._fits(256, 8, 64, 4290, 4, 1)
    assert not refine._fits(256, 8, 64, 14500, 4, 1)
    assert refine.route(256, 8, 64, 14500, f32) == "general"
    # bf16 rows of 100 values are 200 bytes: never the ring route,
    # however small the layout
    assert refine._fits(100, 8, 64, 10, 2, 4)
    assert refine.route(100, 8, 64, 10, torch.bfloat16) == "general"
    assert refine.route(100, 8, 64, 10, f32) == "ring"        # 400 bytes
    # the route depends on the shapes alone
    assert all(refine.route(256, 8, 64, 10, f32) == "ring"
               for _ in range(3))


@pytest.mark.parametrize("L,w", [(96, 16), (100, 10), (90, 5)])
def test_plain_summarize_and_bounds_take_the_new_shapes(L, w):
    from repro.kernels import ref as jref
    x = random_walk(40, L, seed=L)
    pt, wt = isax_summarize.summarize(torch.from_numpy(x), segments=w)
    pj, wj = jref.summarize_ref(jnp.asarray(x), w)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    rng = np.random.default_rng(w)
    lo = (rng.standard_normal((9, w)) - 0.5).astype(np.float32)
    hi = lo + np.abs(rng.standard_normal((9, w))).astype(np.float32)
    dt = lb_distance.lb_distance(pt.contiguous(), torch.from_numpy(lo),
                                 torch.from_numpy(hi), series_len=L)
    dj = jops.lb_distance(pj, jnp.asarray(lo), jnp.asarray(hi),
                          series_len=L, interpret=True)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("L,w,dtype", [(96, 16, "float32"),
                                       (100, 10, "bfloat16")])
def test_search_at_the_new_shapes_answers_repros_ids(L, w, dtype):
    walks = random_walk(700, L, seed=L)
    queries = query_workload(walks, 6, noise_sigma=0.05, seed=L + 1)
    ix = FreshIndex.build(walks, IndexConfig(segments=w, leaf_capacity=32,
                                             dtype=dtype), device="cpu")
    jx = JFreshIndex.build(walks, JIndexConfig(segments=w, leaf_capacity=32,
                                               dtype=dtype))
    for k in (1, 5, 10):
        d, i = ix.search(queries, k=k)
        dj, ij = jx.search(jnp.asarray(queries), k=k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
        np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-5,
                                   atol=1e-5)


# ------------------------------------------------------ DTW and attention
DTW_LENGTHS = (1, 7, 100, 256, 1000, 1024, 1025, 1100, 2709, 8192, 16384,
               16385, 40000)


@pytest.mark.parametrize("L", DTW_LENGTHS)
def test_every_dtw_shape_has_a_route(L):
    """Every L, r (clamped to L - 1, as the wrappers do), round_k and Q
    repro answers gets a route of each DTW kernel, whose launch geometry
    fits a block: the LB in launches of lb_group(L) queries (envelopes
    within 200 KiB to L 1,024; past it, the envelopes in device scratch
    and no shared memory); the search's wave routes to L 1024, its ring
    routes above (a few KB of ring a pair, whatever L; ring16 to r 255),
    the spread route past them or round_k 1024, the diag route where a
    strip row passes shared memory; the scan's band, wave16 / ring16,
    chain and diag routes, the chunk's queries at most 32 and the grid's
    query dimension in launches of 65,535 (any Q)."""
    G = dtw.lb_group(L)
    assert G % 8 == 0 and 8 <= G <= 32
    if L <= 1024:
        assert G * 8 * (-(-L // 4) * 4) <= 200 * 1024
    else:
        g = dtw.lb_long_geometry(G, 1 << 16, L)
        assert g["slots"] in (8, 16, 32) and g["rows"] % g["slots"] == 0
        assert g["rows"] >= G and g["env_bytes"] == 8 * g["rows"] * g["Lp"]
    assert dtw.lb_route(L) in ("vec", "scalar")
    for r in sorted({0, 1, 12, 16, 17, 27, 31, 81, 127, 128, 255, 256,
                     1000, 25599, 25600, 39999}):
        r = min(r, L - 1)
        for round_k in (1, 32, 1024, 1025, 2048):
            route = dtw.dp_route(r, L, round_k)
            if route == "spread":
                assert r > (127 if L <= 1024 else 255) or round_k > 1024
                assert dtw.spread_fits(L, r)
                g = dtw.spread_search_geometry(32, 1 << 20, L, r, round_k)
                assert 1 <= g["slots"] <= 16 and g["smem"] <= 200 * 1024
            elif route == "diag":
                assert not dtw.spread_fits(L, r)
                g = dtw.diag_search_geometry(32, 1 << 20, L, r, round_k)
                assert g["rows"] == 8
                assert g["strips"] == -(-L // 256)
                assert 1 <= g["slots"] <= min(round_k, 1 << 20)
                assert g["bytes"] <= dtw._DIAG_SCRATCH + 8 * 32 * (
                    4 + 1 + min(round_k, 1 << 20) + g["width"])
            elif L <= 1024:
                assert route[:4] == "wave" and round_k <= 1024
                assert r <= dtw.WAVE_MAX_R[route]
                t = dtw.band_threads(r, L, round_k, dtw.wave_cells(route))
                assert t % 32 == 0 and 32 <= t <= 1024
            else:
                assert route == f"ring{dtw.search_ring_cells(r)}"
                assert round_k <= 1024 and r <= dtw.MAX_RING_R
                g = dtw.ring_search_geometry(32, 1 << 20, L, r, round_k,
                                             dtw.wave_cells(route))
                assert g["threads"] % 32 == 0
                assert 32 <= g["threads"] <= dtw.ring_threads(
                    dtw.wave_cells(route))
                assert g["lanes"] <= 32 and g["smem"] <= 200 * 1024
        scan = dtw.scan_route(r, L)
        assert scan == dtw.scan_routes(r, L)[0]
        assert "diag" in dtw.scan_routes(r, L)
        assert ("chain" in dtw.scan_routes(r, L)) == dtw.chain_fits(L, r)
        cells = {**dtw.SCAN_CELLS, **dtw.SCAN_RING_CELLS}
        waves = set(cells) & set(dtw.scan_routes(r, L))
        if waves:
            assert waves == ({"wave16"} if L <= 1024
                             else set(dtw.SCAN_RING_CELLS))
            for route in waves:
                for Q in (1, 32, 65600):
                    g = dtw.scan_geometry(L, r, cells[route], Q)
                    assert g["smem"] <= 200 * 1024
                    assert 1 <= g["queries"] <= 32
                    assert 32 <= g["threads"] <= 512
        elif scan == "chain":
            assert dtw.chain_scan_geometry(L, r)["smem"] <= 200 * 1024


def test_dtw_shapes_before_the_rings_keep_their_routes():
    """Every shape the card routed before the ring routes (L <= 1024,
    round_k <= 1024) keeps its route and geometry."""
    for L in (7, 100, 256, 1024):
        for r in range(0, min(L, 300), 7):
            assert dtw.dp_route(r, L, 32) == dtw.dp_route(r)
            assert dtw.dp_route(r, L, 1024) == dtw.dp_route(r)
            assert dtw.scan_route(r, L) == dtw.scan_route(r)
            assert dtw.scan_routes(r, L) == dtw.scan_routes(r)
    assert dtw.dp_route(12) == "wave2" and dtw.scan_route(12) == "band"
    assert dtw.scan_route(25) == "wave16" and dtw.dp_route(200) == "spread"
    assert dtw.band_threads(12, 256, 32) == 512
    assert dtw.lb_group(1024) == 24 and dtw.lb_group(100) == 32
    assert dtw.scan_geometry(256, 25, 16, 32)["threads"] == 512
    # past them: dtw_search's ring routes at the cells a lane their radius
    # takes (search_ring_cells; ring2 / ring8 / ring16 before), over
    # persistent CTAs of 512 threads past 2 cells a lane (each query's
    # cluster of 8 CTAs of band_threads before: 512 at ring16)
    assert dtw.dp_route(27, 2709) == "ring2"
    assert dtw.dp_route(81, 8192) == "ring6"
    assert dtw.dp_route(135, 2709) == "ring10"
    assert dtw.dp_route(255, 1025) == "ring16"
    assert dtw.dp_route(256, 1025) == "spread"
    assert dtw.ring_search_geometry(32, 1 << 16, 2709, 135, 32,
                                    10)["threads"] == 512
    assert dtw.dp_route(12, 64, 2048) == "spread"
    assert dtw.scan_route(27, 2709) == "ring16"
    assert dtw.scan_route(135, 2709) == "ring18"    # 16 cells a lane: 17
    assert dtw.scan_route(16, 65600) == "band"
    # the LB past L 1,024: 32 queries a launch pair (the envelopes, then
    # the sums over every column: 4 launches of 800 columns before)
    assert dtw.lb_group(2709) == 32
    assert dtw.lb_long_geometry(32, 1 << 16, 2709)["Lp"] == 2712
    # a strip row past a block's shared memory: the diag routes, the
    # rows in device scratch; below, the search's spread route (and the
    # scan's chain route) with the rows in shared memory
    assert dtw.dp_route(25600, 60000) == dtw.scan_route(25600, 60000) \
        == "diag"
    assert dtw.dp_route(25650, 25700, 2048) == "diag"
    assert dtw.dp_route(12672, 60000) == "spread"
    assert dtw.dp_route(12673, 60000) == "diag"
    assert dtw.scan_routes(3072, 60000) == ("chain", "diag")
    assert dtw.scan_routes(3073, 60000) == ("diag",)
    assert dtw.scan_routes(25600, 60000) == ("diag",)
    assert dtw.diag_rows(0) == dtw.diag_rows(255) == 4
    assert dtw.diag_rows(256) == dtw.diag_rows(25600) == 8
    assert all(dtw.spread_fits(L, L - 1) for L in (1, 1024, 16384))


def test_diag_geometry():
    """The diag routes' launch geometry (kernels.dtw.diag_*, pure): strips
    of 32 rows-a-lane rows a pair, a strip row's entries (its columns),
    chains (a pair's strips on one warp where a strip
    overlaps the next for less than half its steps), the pairs in flight
    and the scratch within its budget, the scan's grid and the search's
    cluster, at the device band's shape, the long queries' and the full
    window's, and past every cap."""
    assert dtw.DIAG_ROWS == (4, 8)
    assert dtw.diag_strips(25700, 8) == 101 and dtw.diag_strips(1, 4) == 1
    assert dtw.diag_strips(16400, 4) == 129 and dtw.diag_strips(256, 8) == 1
    assert dtw.diag_width(25700, 25650, 8) == 25700
    assert dtw.diag_width(16400, 12, 4) == 24 + 128
    # a strip of a narrow band barely overlaps the next: one warp a pair
    assert dtw.diag_chain(16400, 12, 4) == dtw.diag_chain(16400, 40, 4) \
        == 129
    assert dtw.diag_chain(16400, 200, 4) == 1
    assert dtw.diag_chain(25700, 25650, 8) == dtw.diag_chain(1024, 1023, 8) \
        == 1
    # the device band: 2 queries x 3 series
    g = dtw.diag_scan_geometry(2, 3, 25700, 25650)
    assert (g["rows"], g["strips"], g["chain"], g["slots"]) == (8, 101, 1, 6)
    assert g["tickets"] == 6 * 101 and g["width"] == 25700
    assert g["entries"] == 1 + 6 + 6 * 25700 and g["bytes"] == 8 * g["entries"]
    g = dtw.diag_search_geometry(2, 3, 25700, 25650, 32)
    assert (g["rows"], g["strips"], g["slots"]) == (8, 101, 3)
    assert g["per_query"] == 4 + 3 + 3 + 3 * 25700
    assert g["bytes"] == 8 * 2 * g["per_query"]
    # the long queries at r 12: a chain a pair, every pair in flight
    g = dtw.diag_scan_geometry(4, 256, 16400, 12)
    assert (g["rows"], g["chain"], g["slots"], g["tickets"]) == \
        (4, 129, 1024, 1024)
    # caps: pairs in flight and scratch
    g = dtw.diag_scan_geometry(65600, 64, 16, 3)
    assert g["slots"] == dtw._DIAG_SLOTS
    g = dtw.diag_scan_geometry(32, 1000, 60000, 30000)
    assert 1 <= g["slots"] < 32000
    assert g["bytes"] <= dtw._DIAG_SCRATCH + 8 * (1 + 1 + g["width"])
    g = dtw.diag_search_geometry(32, 1000, 60000, 30000, 1000)
    assert g["slots"] >= 1
    assert g["bytes"] <= dtw._DIAG_SCRATCH + 8 * 32 * (4 + 1 + 1000
                                                      + g["width"])
    # the scan's grid: what the card holds, no more than the warps needed
    assert dtw.diag_grid(6 * 101, 528) == 76
    assert dtw.diag_grid(10 ** 6, 528) == 528 and dtw.diag_grid(1, 528) == 1
    # the search's cluster: 16 where the card holds one, else 8
    assert dtw.diag_cluster(7, 15) == 16 and dtw.diag_cluster(0, 15) == 8
    with pytest.raises(RuntimeError):
        dtw.diag_cluster(0, 0)


def test_ring_scan_cells_by_radius():
    """dtw_scan past L 1,024 takes its cells a lane by radius
    (scan_ring_cells): of the even widths 16-24, the one that puts the
    largest share of a warp's lane cells on band cells, P (2r + 1) / (32
    C), the narrowest on ties.  Over r 17-255 that share is 0.92 on
    average and 0.75 at worst (0.79 and 0.50 at 16 cells alone), and
    every radius keeps at least 25 of 32 lanes busy (at 16 cells alone
    17 at r 135 and 128-143), 30.5 on average (26.4 at 16 alone); the
    long cell's radii: r 27 stays at 16 cells (H 4, P 8: 32 busy), r 81
    takes 22 (H 8, P 4: 32, from 22) and r 135 18 (H 16, P 2: 32, from
    17); r 255 stays at 16 (H 32).  At L <= 1,024 the wave route keeps
    16 cells."""
    def lanes_busy(r, c):
        H, P = dtw.scan_lanes(r, c)
        return H * P

    def share(r, c):
        return dtw.scan_lanes(r, c)[1] * (2 * r + 1) / (32 * c)
    busy, at16, shares = {}, {}, []
    for r in range(17, 256):
        C = dtw.scan_ring_cells(r)
        busy[r], at16[r] = lanes_busy(r, C), lanes_busy(r, 16)
        assert busy[r] >= 25
        assert share(r, C) == max(share(r, c) for c in dtw.SCAN_RING_WIDTHS)
        assert share(r, C) >= share(r, 16)
        shares.append((share(r, C), share(r, 16)))
        assert dtw.scan_route(r, 2709) == f"ring{C}"
        assert dtw.scan_route(r, 1024) == "wave16"
    assert min(busy.values()) == 25 and min(at16.values()) == 17
    assert round(sum(busy.values()) / len(busy), 1) == 30.5
    assert round(sum(at16.values()) / len(at16), 1) == 26.4
    new, old = np.array(shares).T
    assert (round(new.mean(), 2), round(new.min(), 2)) == (0.92, 0.75)
    assert (round(old.mean(), 2), round(old.min(), 2)) == (0.79, 0.5)
    assert [dtw.scan_route(r, 2709) for r in (27, 81, 135, 255)] == [
        "ring16", "ring22", "ring18", "ring16"]
    assert [busy[r] for r in (27, 81, 135, 255)] == [32, 32, 32, 32]
    assert [at16[r] for r in (27, 81, 135, 255)] == [32, 22, 17, 32]
    assert dtw.scan_ring_cells(17) == 18 and dtw.scan_lanes(17, 16) == (3, 10)


def test_every_head_width_has_an_attention_route():
    """Each dtype's route of every head width to 640: the narrowest
    instance at least dh (to 256, then the instances of halved O to
    512), on the tensor cores for bfloat16 (by TMA, "tc", where a row is
    whole 16-byte pieces, else by TMA over copies whose rows are padded
    to them, "staged"); for float32 on the tensor cores in TF32 from dh
    129 to 256 ("tf") and on the FMAs below and above ("simt"); the wide
    route only past 512."""
    widths = flash_attention.INSTANCES + flash_attention.HALVES
    for dh, dtype in itertools.product(range(1, 641),
                                       (torch.bfloat16, torch.float32)):
        r = flash_attention.route(dtype, dh)
        if dh > 512:
            assert r == "wide"
            continue
        if dtype == torch.bfloat16:
            name = "tc" if dh % 8 == 0 else "staged"
        else:
            name = "tf" if 128 < dh <= 256 else "simt"
        width = int(r[len(name):])
        assert r.startswith(name) and width in widths
        assert width >= dh
        assert all(w < dh for w in widths if w < width)


def test_the_attention_shapes_before_keep_their_routes():
    bf16, f32 = torch.bfloat16, torch.float32
    for dh in (32, 64, 128):
        assert flash_attention.route(bf16, dh) == f"tc{dh}"
        assert flash_attention.route(f32, dh) == f"simt{dh}"
    for dh in (129, 160, 200, 255, 256):      # float32 in TF32 (was simt256)
        assert flash_attention.route(f32, dh) == "tf256"
    assert flash_attention.route(bf16, 96) == "tc96"
    assert flash_attention.route(bf16, 256) == "tc256"
    assert flash_attention.route(bf16, 40) == "tc64"
    assert flash_attention.route(bf16, 80) == "tc96"
    assert flash_attention.route(bf16, 100) == "staged128"   # 200-byte rows
    assert flash_attention.route(bf16, 36) == "staged64"     # 72-byte rows
    assert flash_attention.route(f32, 100) == "simt128"
    assert flash_attention.route(bf16, 320) == "tc320"    # O in halves
    assert flash_attention.route(bf16, 264) == "tc320"
    assert flash_attention.route(bf16, 512) == "tc512"
    assert flash_attention.route(bf16, 520) == "wide"
    assert flash_attention.route(f32, 320) == "simt320"   # O in halves
    assert flash_attention.route(f32, 257) == "simt320"


def test_the_tf32_route_splits_once_then_launches_blocks_of_64_rows():
    """The float32 route at dh 129-256 launches its split of K and V
    once, then the kernel on blocks of 64 query rows, 65,535 blocks a
    launch; its scratch is K_hi, K_lo, V^T_hi and V^T_lo: four times K's
    size where dh is a multiple of 4 and S of 8."""
    assert flash_attention.ROWS["tf"] == 64
    top = flash_attention.MAX_QBLOCKS * 64
    for T, want in ((1, 2), (4096, 2), (top, 2), (top + 1, 3),
                    (2 * top + 1, 4)):
        assert flash_attention.query_launches(T, "tf256") == want
    assert flash_attention.tf32_scratch(1, 2, 1024, 256) == 4 * 2 * 1024 * 256
    assert flash_attention.tf32_scratch(1, 8, 32768, 256) * 4 == 2 ** 30
    # dh 255 pads K's rows to 256, S 1001 V^T's to 1008
    assert flash_attention.tf32_scratch(1, 1, 1001, 255) == \
        2 * (1001 * 256 + 255 * 1008)


@pytest.mark.parametrize("name,rows", [("tc128", 128), ("tc512", 128),
                                       ("simt96", 64), ("wide", 16)])
def test_attention_takes_any_number_of_query_rows(name, rows):
    """Every T launches: the grid's y dimension takes 65,535 blocks of a
    route's query rows, and a longer T goes in more launches (one to
    65,535 blocks, two past them: 1,048,576 + 16 rows on the wide route,
    4,194,304 + 64 on the FMAs, 8,388,480 + 128 on the tensor cores)."""
    top = flash_attention.MAX_QBLOCKS * rows
    assert flash_attention.ROWS[name.rstrip("0123456789")] == rows
    assert flash_attention.query_launches(1, name) == 1
    assert flash_attention.query_launches(4096, name) == 1
    assert flash_attention.query_launches(top, name) == 1
    assert flash_attention.query_launches(top + 1, name) == 2
    assert flash_attention.query_launches(2 * top + 1, name) == 3


def test_a_staged_route_pads_once_then_launches_as_its_twin():
    """The staged routes (bf16 rows not whole 16-byte pieces) launch the
    padding kernel once, then the tensor-core instance as the TMA route
    of the same width does: 65,535 blocks of 128 query rows a launch."""
    top = flash_attention.MAX_QBLOCKS * flash_attention.ROWS["staged"]
    assert flash_attention.ROWS["staged"] == flash_attention.ROWS["tc"]
    for T in (1, 4096, top, top + 1, 2 * top + 1):
        assert flash_attention.query_launches(T, "staged128") == \
            flash_attention.query_launches(T, "tc128") + 1


@pytest.mark.parametrize("name", ["simt320", "simt384", "simt448",
                                  "simt512"])
def test_float32_halves_take_any_t_in_one_launch(name):
    """The float32 instances past 256 put (head, half of O, pair of query
    blocks) on the grid's x, which takes 2^31 - 1 blocks: one launch at
    any T, where the other routes' grid y takes 65,535 query blocks."""
    top = flash_attention.MAX_QBLOCKS * flash_attention.ROWS["simt"]
    for T in (1, 4096, top, top + 1, 4 * top + 1):
        assert flash_attention.query_launches(T, name) == 1
    assert flash_attention.query_launches(top + 1, "simt128") == 2


def test_ring_search_cells_by_radius():
    """dtw_search past L 1,024 takes its cells a lane by radius
    (search_ring_cells): of the even widths 2-16 whose lanes hold the
    band (at most 32 a pair), the least C (1 + 1 / P), a DP's chain (C a
    step) plus a busy card's cost a pair (C / P, the scan's measure of
    idle lanes), the narrowest on ties.  That is the narrowest width at
    every radius 0-255: the lanes of a pair past r 15 are 17 to 32.  The
    long cell's radii: r 27 keeps 2 cells (H 28), r 81 takes 6 (H 28,
    where ring8 left 11 of 32 lanes idle), r 135 10 (H 28, where ring16
    left 15 idle); the long queries' r 12, 40, 200 take 2, 4, 14.  Every
    width's CTA fits shared memory at every radius it takes, the query
    staged or not."""
    def cost(r, c):
        return c * (1 + 1 / dtw.scan_lanes(r, c)[1])
    for r in range(256):
        widths = dtw.ring_widths(r)
        C = dtw.search_ring_cells(r)
        assert C == widths[0] and widths[-1] == 16
        assert cost(r, C) == min(cost(r, c) for c in widths)
        H, P = dtw.scan_lanes(r, C)
        assert H * P <= 32 and (C == 2 or dtw.scan_lanes(r, C - 2)[0] > 32)
        if r > 15:
            assert P == 1 and 17 <= H <= 32
        assert dtw.dp_route(r, 2709) == f"ring{C}"
        assert dtw.dp_routes(r, 2709)[:len(widths)] == tuple(
            f"ring{c}" for c in widths)
        for c in widths:
            for L in (1025, 16384, 16385):
                g = dtw.ring_search_geometry(4, 256, L, r, 256, c)
                assert g["smem"] <= 200 * 1024 and g["threads"] % 32 == 0
                assert 32 <= g["threads"] <= dtw.ring_threads(c)
                assert g["ring"] == dtw.ring_size(c, g["lanes"]) <= 1024
    assert [dtw.search_ring_cells(r) for r in (27, 81, 135)] == [2, 6, 10]
    assert [dtw.scan_lanes(r, c)[0] for r, c in ((27, 2), (81, 6), (135, 10),
                                                 (81, 8), (135, 16))] \
        == [28, 28, 28, 21, 17]
    assert [dtw.search_ring_cells(r) for r in (12, 40, 200, 255)] == \
        [2, 4, 14, 16]
    assert dtw.ring_threads(2) == 1024 and dtw.ring_threads(4) == 512
