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
from repro_torch.kernels import (ed_argmin, isax_summarize, lb_distance,
                                 refine, refine_search)
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
    assert ed_argmin.route(L) in ("tensor", "general")


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
    assert ed_argmin.route(100) == "general"


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
