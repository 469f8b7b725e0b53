"""DTW search of the port (repro_torch.core.dtw, the plain versions of
csrc/dtw.cu on the CPU) against repro's on the same seeded numpy inputs:
tests/test_dtw.py's cases on both packages, envelope and LB_Keogh,
banded DTW against repro's and the O(L^2) oracle, and both searches at
round_k 16 and 32, N not a multiple of round_k, N < round_k, r = 0, 16,
25 and 40 and znorm=False: ids equal but where two distances lie within
1e-5 relative, distances to rtol 1e-5.  The LB_Keogh kernel's clamp-form
excursion against repro's form, bit for bit; the wavefront routes' lane
schedule (ref.dtw_wavefront_ref, 2, 4 and 8 cells a lane) against the
band, bit for bit.  Then isax's four distance helpers against repro's on
tests/test_isax.py's inputs.

Tolerances: the port sums LB_Keogh in another order than XLA (rtol 1e-5);
the DP repeats repro's arithmetic cell for cell, so banded DTW agrees to
float32 rounding of the z-normalization (rtol 1e-5); the oracle is
float64 (rtol 1e-5, repro's own)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dtw as J
from repro.core import isax as jisax
from repro_torch.core import dtw as T
from repro_torch.core import isax
from repro_torch.kernels import dtw as kdtw
from repro_torch.kernels import ref

torch.set_num_threads(2)


def _pair(seed, L=32):
    rng = np.random.default_rng(seed)
    q = np.cumsum(rng.standard_normal(L)).astype(np.float32)
    x = np.cumsum(rng.standard_normal(L)).astype(np.float32)
    return q, x


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _same_answers(d, i, jd, ji, rtol=1e-5):
    """Distances to rtol; ids equal except where the two answers'
    distances lie within rtol of each other (a tie)."""
    d, i = d.numpy(), i.numpy()
    jd, ji = np.asarray(jd), np.asarray(ji)
    np.testing.assert_allclose(d, jd, rtol=rtol, atol=1e-6)
    mism = i != ji
    if mism.any():
        np.testing.assert_allclose(d[mism], jd[mism], rtol=rtol)


# ---------------------------------------- tests/test_dtw.py on both packages
@pytest.mark.parametrize("r", [1, 4, 8, 16])
def test_dtw_band_matches_oracle(r):
    q, x = _pair(0, 48)
    want = T.dtw_ref(q, x, r)
    assert want == J.dtw_ref(q, x, r)
    for got in (float(T.dtw_band(_t(q), _t(x), r)),
                float(J.dtw_band(jnp.asarray(q), jnp.asarray(x), r))):
        assert abs(got - want) / max(want, 1e-9) < 1e-5


@pytest.mark.parametrize("r", [1, 4, 8, 16])
def test_dtw_band_equals_repros(r):
    """The port's DP repeats repro's: the same float32 bits here."""
    for seed in range(3):
        q, x = _pair(seed, 48)
        got = T.dtw_band(_t(q), _t(x), r)
        want = np.float32(J.dtw_band(jnp.asarray(q), jnp.asarray(x), r))
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= 1e-5 * float(want)


def test_dtw_identity_is_zero():
    q, _ = _pair(1)
    assert float(T.dtw_band(_t(q), _t(q), 4)) < 1e-9


def test_dtw_leq_euclidean():
    q, x = _pair(2)
    ed = float(((q - x) ** 2).sum())
    for r in (0, 2, 8):
        assert float(T.dtw_band(_t(q), _t(x), r)) <= ed + 1e-4


def test_dtw_r0_is_squared_euclidean():
    q, x = _pair(9)
    np.testing.assert_allclose(float(T.dtw_band(_t(q), _t(x), 0)),
                               float(((q - x) ** 2).sum()), rtol=1e-6)


def test_envelope_contains_query():
    q, _ = _pair(3)
    lo, hi = T.envelope(_t(q), 5)
    assert np.all(lo.numpy() <= q + 1e-6)
    assert np.all(q <= hi.numpy() + 1e-6)


@pytest.mark.parametrize("r", [0, 2, 5, 9, 40])
def test_envelope_and_lb_keogh_equal_repros(r):
    rng = np.random.default_rng(r)
    q = np.cumsum(rng.standard_normal(40)).astype(np.float32)
    xs = np.cumsum(rng.standard_normal((17, 40)), axis=1).astype(np.float32)
    lo, hi = T.envelope(_t(q), r)
    jlo, jhi = J.envelope(jnp.asarray(q), r)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_allclose(
        T.lb_keogh(_t(q), _t(xs), r).numpy(),
        np.asarray(J.lb_keogh(jnp.asarray(q), jnp.asarray(xs), r)),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", range(20))
def test_lb_keogh_lower_bounds_dtw(seed):
    """THE soundness property: LB_Keogh <= banded DTW, always."""
    for r in (2, 5, 9):
        q, x = _pair(seed, 24)
        lb = float(T.lb_keogh(_t(q), _t(x)[None, :], r)[0])
        d = T.dtw_ref(q, x, r)
        assert lb <= d + 1e-4 * max(d, 1.0), (lb, d)


def test_search_dtw_exact_vs_bruteforce():
    rng = np.random.default_rng(7)
    X = np.cumsum(rng.standard_normal((300, 64)), axis=1).astype(np.float32)
    Q = X[rng.integers(0, 300, 6)] + 0.05 * rng.standard_normal(
        (6, 64)).astype(np.float32)
    d, i = T.search_dtw(X, Q, r=6, round_k=16, device="cpu")
    db, ib = T.search_dtw_bruteforce(X, Q, r=6, device="cpu")
    _same_answers(d, i, db.numpy(), ib.numpy())
    jd, ji = J.search_dtw(jnp.asarray(X), jnp.asarray(Q), r=6, round_k=16)
    _same_answers(d, i, jd, ji)


def test_search_dtw_finds_warped_twin():
    rng = np.random.default_rng(8)
    base = np.cumsum(rng.standard_normal(64)).astype(np.float32)
    warped = np.interp(np.linspace(0, 63, 64) + 2 * np.sin(
        np.linspace(0, 3, 64)), np.arange(64), base).astype(np.float32)
    X = np.cumsum(rng.standard_normal((100, 64)), axis=1).astype(np.float32)
    X[37] = warped
    d, i = T.search_dtw(X, base[None, :], r=8, device="cpu")
    assert int(i[0]) == 37


# ------------------------------------------------ both searches vs repro
CASES = [
    # (N, L, Q, r, round_k, znorm)
    (300, 64, 6, 6, 16, True),
    (300, 64, 6, 6, 32, True),
    (301, 48, 5, 4, 32, True),       # N not a multiple of round_k
    (21, 32, 4, 3, 32, True),        # N < round_k
    (120, 40, 4, 0, 16, True),       # r = 0: squared ED
    (150, 40, 4, 16, 32, True),      # band wider than a warp
    (150, 64, 4, 25, 32, True),      # wave2 at a wide band
    (130, 64, 4, 40, 16, True),      # wave4: 4 cells a lane
    (150, 40, 4, 5, 16, False),      # raw values
]


@pytest.mark.parametrize("N,L,Q,r,round_k,znorm", CASES)
def test_searches_equal_repros(N, L, Q, r, round_k, znorm):
    rng = np.random.default_rng(N + L + r)
    X = np.cumsum(rng.standard_normal((N, L)), axis=1).astype(np.float32)
    Qs = (X[rng.integers(0, N, Q)] + 0.1 * rng.standard_normal((Q, L))
          ).astype(np.float32)
    jd, ji = J.search_dtw(jnp.asarray(X), jnp.asarray(Qs), r=r,
                          round_k=round_k, znorm=znorm)
    d, i = T.search_dtw(X, Qs, r=r, round_k=round_k, znorm=znorm,
                        device="cpu")
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    assert d.device.type == "cpu" and d.shape == (Q,)
    _same_answers(d, i, jd, ji)
    jbd, jbi = J.search_dtw_bruteforce(jnp.asarray(X), jnp.asarray(Qs),
                                       r=r, znorm=znorm)
    bd, bi = T.search_dtw_bruteforce(X, Qs, r=r, znorm=znorm, device="cpu")
    _same_answers(bd, bi, jbd, jbi)
    _same_answers(d, i, bd.numpy(), bi.numpy())


def test_search_with_no_series_takes_no_candidate():
    """N = 0 (repro's jitted search cannot slice an empty collection): no
    round runs, the answer is sqrt(BIG) and id -1, repro's values for a
    query no candidate was taken for."""
    X = np.zeros((0, 32), np.float32)
    Qs = np.random.default_rng(0).standard_normal((2, 32)).astype(
        np.float32)
    d, i = T.search_dtw(X, Qs, r=3, znorm=False, device="cpu")
    assert i.tolist() == [-1, -1]
    assert d.tolist() == [float(np.sqrt(np.float32(J.BIG)))] * 2


def test_search_ref_rounds_and_prune_rule():
    """The refinement's plain version by hand: a round's candidate whose
    bound is >= the best-so-far at the round's start is never refined,
    and the loop stops at the first bound >= the best-so-far."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor(np.cumsum(rng.standard_normal((70, 16)), axis=1),
                        dtype=torch.float32)
    q = x[5:6] + 0.01
    lb = ref.lb_keogh_ref(q, x, 2)
    s, o = torch.sort(lb, dim=1, stable=True)
    bsf, best, rounds, refined = kdtw.dtw_search(q, x, s, o, r=2,
                                                 round_k=8)
    d = ref.dtw_band_ref(q[0], x, 2)
    assert int(best[0]) == int(torch.argmin(d))
    assert float(bsf[0]) == float(d.min())
    # every round ran while its first bound was below the answer, and
    # only candidates below the best-so-far were refined
    assert int(rounds[0]) >= 1 and int(refined[0]) <= 8 * int(rounds[0])
    assert int(refined[0]) >= int((s[0] < bsf[0]).sum())
    n_rounds_needed = int((s[0, ::8] < bsf[0]).sum())
    assert int(rounds[0]) == n_rounds_needed


def _rounds_one_by_one(q, x, s, o, r, rk, starts=None):
    """The refinement's loop as its docstring states it: one query, one
    round and one DP call at a time; `starts` receives each query's
    (round start, best-so-far there) pairs."""
    Qg, N = s.shape
    out = []
    for g in range(Qg):
        bsf, best, rounds, refined, cursor = ref.BIG, -1, 0, 0, 0
        bsf = np.float32(bsf)
        if starts is not None:
            starts.append([])
        while cursor < N and float(s[g, cursor]) < bsf:
            if starts is not None:
                starts[g].append((cursor, float(bsf)))
            lbs = s[g, cursor:cursor + rk].numpy()
            ids = o[g, cursor:cursor + rk].numpy()
            take = lbs < bsf
            d = np.full(len(lbs), np.float32(ref.BIG), np.float32)
            if take.any():
                d[take] = ref.dtw_band_ref(q[g], x[torch.as_tensor(
                    ids[take])], r).numpy()
            k = int(np.argmin(d))
            if d[k] < bsf:
                bsf, best = d[k], int(ids[k])
            rounds += 1
            refined += int(take.sum())
            cursor += rk
        out.append((float(bsf), best, rounds, refined))
    return out


@pytest.mark.parametrize("N,L,Q,r,rk,noise,max_pairs", [
    (4000, 64, 8, 4, 16, 0.3, 1 << 16), (4000, 64, 8, 4, 8, 0.2, 96),
    (4000, 64, 6, 6, 32, 0.4, 512), (1500, 48, 5, 3, 5, 0.25, 7),
    (700, 40, 4, 0, 7, 0.3, 100), (20, 32, 3, 2, 32, 0.5, 1 << 16)])
def test_search_ref_equals_a_round_by_round_loop(N, L, Q, r, rk, noise,
                                                 max_pairs):
    """dtw_search_ref takes its distances a chunk of rounds at a time,
    for every query still running at once: the same bsf, id, rounds and
    candidates refined as one round of one query at a time, whatever the
    chunk (max_pairs down to one round); its trace holds each round's
    start and the best-so-far there, the loop's."""
    rng = np.random.default_rng(N + L + rk)
    x = isax.znormalize(torch.as_tensor(
        np.cumsum(rng.standard_normal((N, L)), 1), dtype=torch.float32))
    q = x[torch.as_tensor(rng.integers(0, N, Q))] + noise * torch.as_tensor(
        rng.standard_normal((Q, L)), dtype=torch.float32)
    s, o = torch.sort(ref.lb_keogh_ref(q, x, r), dim=1, stable=True)
    trace, starts = [], []
    bsf, best, rounds, refined = ref.dtw_search_ref(
        q, x, s, o, r, rk, max_pairs=max_pairs, trace=trace)
    got = list(zip(bsf.tolist(), best.tolist(), rounds.tolist(),
                   refined.tolist()))
    assert got == _rounds_one_by_one(q, x, s, o, r, rk, starts)
    assert [list(zip(c.tolist(), b.tolist())) for c, b in trace] == starts
    # r 0 (the bound is the distance) and N < round_k end in one round
    assert max(rounds.tolist()) > 1 or r == 0 or N < rk


def test_search_groups_queries():
    """More queries than a group: the groups' answers equal one query at
    a time."""
    rng = np.random.default_rng(11)
    X = np.cumsum(rng.standard_normal((64, 16)), axis=1).astype(np.float32)
    Qs = X[rng.integers(0, 64, T.GROUP + 3)] + 0.1 * rng.standard_normal(
        (T.GROUP + 3, 16)).astype(np.float32)
    d, i = T.search_dtw(X, Qs, r=2, round_k=8, device="cpu")
    for j in (0, T.GROUP - 1, T.GROUP, T.GROUP + 2):
        dj, ij = T.search_dtw(X, Qs[j:j + 1], r=2, round_k=8, device="cpu")
        assert float(dj[0]) == float(d[j]) and int(ij[0]) == int(i[j])


def test_searches_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    X = np.zeros((4, 16), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.search_dtw(X, X[:1])
    with pytest.raises(RuntimeError, match="CUDA"):
        T.search_dtw_bruteforce(X, X[:1])


# ----------------------------------------- the plain versions, one by one
def test_dtw_band_ref_broadcasts_over_pairs():
    rng = np.random.default_rng(4)
    qs = np.cumsum(rng.standard_normal((5, 20)), axis=1).astype(np.float32)
    xs = np.cumsum(rng.standard_normal((5, 20)), axis=1).astype(np.float32)
    got = ref.dtw_band_ref(_t(qs), _t(xs), 3)
    for j in range(5):
        assert float(got[j]) == float(ref.dtw_band_ref(_t(qs[j]),
                                                       _t(xs[j]), 3))
        np.testing.assert_allclose(float(got[j]), T.dtw_ref(qs[j], xs[j], 3),
                                   rtol=1e-5)


@pytest.mark.parametrize("L,r", [(5, 3), (7, 12), (1, 0), (1, 4)])
def test_dtw_band_when_the_band_is_wider_than_the_series(L, r):
    rng = np.random.default_rng(L * 10 + r)
    q, x = (rng.standard_normal(L).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(float(T.dtw_band(_t(q), _t(x), r)),
                               T.dtw_ref(q, x, r), rtol=1e-5)
    np.testing.assert_allclose(
        float(T.dtw_band(_t(q), _t(x), r)),
        float(J.dtw_band(jnp.asarray(q), jnp.asarray(x), r)), rtol=1e-6)


def test_scan_ref_first_index_on_ties():
    x = torch.zeros(6, 8)
    x[2] = 1.0
    q = torch.ones(1, 8)
    d2, i = kdtw.dtw_scan(torch.zeros(1, 8), x, r=1)
    assert int(i[0]) == 0 and float(d2[0]) == 0.0
    d2, i = kdtw.dtw_scan(q, x, r=1)
    assert int(i[0]) == 2 and float(d2[0]) == 0.0


@pytest.mark.parametrize("L", [1, 100, 224, 225, 256, 257, 1023, 1024])
def test_routes_cover_every_length(L):
    """One LB_Keogh kernel takes every L <= 1024: 16-byte loads where L %
    4 == 0 and the collection is aligned, 4-byte ones otherwise; a
    launch's queries are a multiple of 8 slots whose (lo, hi) envelopes
    (L padded to 4 points) fit in 200 KiB."""
    assert kdtw.lb_route(L) == ("vec" if L % 4 == 0 else "scalar")
    assert kdtw.lb_route(L, aligned=False) == "scalar"
    Lp = -(-L // 4) * 4
    assert 8 <= kdtw.lb_group(L) <= kdtw.GROUP
    assert kdtw.lb_group(L) % 8 == 0
    assert kdtw.lb_group(L) * 8 * Lp <= 200 * 1024
    assert kdtw.lb_group(L) == (32 if L <= 800 else 24)


def test_dp_routes():
    """dtw_search: the wave routes of 2, 4 and 8 cells a lane to r 31, 63
    and 127 (at most 32 lanes a pair), the spread route beyond; dtw_scan:
    band to r 16, then the wave route of 16 cells a lane to r 255, then
    chain."""
    rs = (0, 12, 16, 17, 25, 31, 32, 40, 63, 64, 100, 127, 128, 900)
    assert [kdtw.dp_route(r) for r in rs] == (
        ["wave2"] * 6 + ["wave4"] * 3 + ["wave8"] * 3 + ["spread"] * 2)
    assert [kdtw.scan_route(r) for r in rs] == \
        ["band"] * 3 + ["wave16"] * 10 + ["chain"]
    assert kdtw.WAVE_MAX_R == {"wave2": 31, "wave4": 63, "wave8": 127}
    for r in rs:
        route = kdtw.dp_route(r)
        if route != "spread":
            assert -(-(2 * r + 1) // kdtw.wave_cells(route)) <= 32


@pytest.mark.parametrize("r", [0, 1, 12, 16, 17, 25, 31, 40, 63, 100])
@pytest.mark.parametrize("L", [7, 100, 256])
def test_wavefront_model_equals_the_band(r, L):
    """The wavefront routes' order (ref.dtw_wavefront_ref with the cells a
    lane of dp_route(r): lane l of a pair holds offsets cells * l ..
    cells * l + cells - 1, step s forms row s - l, every operand asserted
    the right cell and formed at an earlier wavefront) gives
    dtw_band_ref's bits, and repro's dtw_band within the tolerance of the
    tests above."""
    rng = np.random.default_rng(1000 * r + L)
    q, x = (rng.standard_normal((3, L)).astype(np.float32)
            for _ in range(2))
    cells = kdtw.wave_cells(kdtw.dp_route(r))
    got = ref.dtw_wavefront_ref(_t(q), _t(x), r, cells)
    assert torch.equal(got, ref.dtw_band_ref(_t(q), _t(x), r))
    for j in range(3):
        want = float(J.dtw_band(jnp.asarray(q[j]), jnp.asarray(x[j]), r))
        assert abs(float(got[j]) - want) <= 1e-5 * want


@pytest.mark.parametrize("r,cells", [(17, 2), (25, 2), (31, 2), (40, 4),
                                     (63, 4), (100, 8), (25, 4), (12, 8)])
def test_every_path_costs_each_steps_least_cell(r, cells):
    """The wide routes' early abandoning: from the step of cell (0, 0),
    r // cells, to the last, each step's least cell inside the band and
    the matrix is at most the DTW (every path has a cell of every step
    between, and costs are non-negative), so a pair whose least cell of a
    step reaches the best-so-far cannot improve it."""
    rng = np.random.default_rng(7 * r + cells)
    for L in (9, 64, 130):
        q, x = (rng.standard_normal((4, L)).astype(np.float32)
                for _ in range(2))
        d, least = ref.dtw_wavefront_ref(_t(q), _t(x), r, cells,
                                         step_least=True)
        assert torch.equal(d, ref.dtw_band_ref(_t(q), _t(x), r))
        l0 = r // cells
        assert bool((least[:, l0:] <= d[:, None]).all())
        assert bool((least[:, l0:] < ref.BIG).all())


@pytest.mark.parametrize("r", [0, 1, 12, 15, 16, 17, 25, 31, 32, 63, 64,
                               127])
def test_band_route_blocks(r):
    """dtw_search's wave-route CTAs (band_threads): whole warps,
    32 to 1024 threads, 32 // lanes pairs a warp (lanes = ceil((2r + 1) /
    cells)), never more warps than a round's pairs need, the pairs'
    series, the query and the round's distances and bounds (twice) within
    the CTA's shared memory; the dtw cell's shape (r 12, round_k 32) takes
    16 warps of 2 pairs, the wide run's (r 25) 32 warps of 1."""
    cells = kdtw.wave_cells(kdtw.dp_route(r))
    for L, round_k in itertools.product((1, 7, 100, 256, 1024),
                                        (1, 16, 32, 100, 1024)):
        t = kdtw.band_threads(r, L, round_k, cells)
        P = 32 // -(-(2 * r + 1) // cells)
        assert t % 32 == 0 and 32 <= t <= 1024
        assert t // 32 <= -(-round_k // P)
        assert 4 * (L + 4 * round_k + t // 32 * P * L) <= 200 * 1024
    assert kdtw.band_threads(12, 256, 32) == 512
    assert kdtw.band_threads(25, 256, 32, 2) == 1024


# -------------------------------------------- dtw_scan's wave route (PR 24)
@pytest.mark.parametrize("L", [1, 2, 3, 7, 16, 100, 255, 256, 257, 300,
                               511, 512, 1000, 1023, 1024])
def test_scan_wave_geometry(L):
    """Every radius dtw_scan's wave route takes (2r + 1 offsets over at
    most 32 lanes of 16 cells), at this length (r clamped to L - 1):
    whole warps, 32 to 512 threads, 1 to 32 queries a chunk, the chunk's
    query rows and every warp's tile within 200 KiB; the tile's pads
    cover every column a lane reads (r - l0 before a row, l0 + cells H -
    H - r after it), the query rows every row index (l0 - (H - 1) .. l0 +
    L - 1), and the 16-byte copies stay aligned."""
    assert kdtw.SCAN_CELLS == {"wave16": 16}
    C = 16
    assert kdtw.SCAN_MAX_R["wave16"] == (32 * C - 1) // 2 == 255
    for r in range(min(255, L - 1) + 1):
        for Q in (1, 5, 32, 40):
            g = kdtw.scan_geometry(L, r, C, Q)
            H, P, l0 = g["lanes"], g["pairs"], r // C
            assert H == -(-(2 * r + 1) // C) <= 32 and P == 32 // H
            assert g["smem"] <= 200 * 1024
            assert g["smem"] == 4 * (g["queries"] * g["qstride"] + (
                g["threads"] // 32) * (g["pad"] + P * g["stride"]))
            assert g["threads"] % 32 == 0 and 32 <= g["threads"] <= 512
            assert 1 <= g["queries"] <= min(Q, 32)
            assert g["pad"] >= max(r - l0, l0 + C * H - H - r)
            assert g["stride"] >= L + g["pad"]
            assert g["qstride"] >= H + L + l0
            for k in ("pad", "stride", "qstride"):
                assert g[k] % 4 == 0


def test_scan_wave_geometry_at_the_dtw_cell():
    """At the dtw cell's length (L 256) the route of each radius the card
    runs keeps 16 warps a CTA and a chunk of 32 queries, and the pairs'
    lanes read 32 apart banks (the row stride apart by shift mod 32)."""
    for r, C, H in ((25, 16, 4), (51, 16, 7), (102, 16, 13)):
        g = kdtw.scan_geometry(256, r, C, 32)
        assert g["lanes"] == H
        assert (g["threads"], g["queries"]) == (512, 32)
        P = g["pairs"]
        banks = {(p * g["stride"] + (C - 1) * ll) % 32
                 for p in range(P) for ll in range(H)}
        assert len(banks) == P * H


@pytest.mark.parametrize("L", [1, 16, 300, 1024, 2709, 8192])
def test_strip_routes_fit_every_band(L):
    """The chain and spread routes' geometry (pure functions) at every r
    <= L - 1 (every 7th past 1,024): a strip row holds the strip's columns
    (diag_width); the spread route, where a row fits (spread_fits: every
    r to L 25,600), keeps 1 to 16 pairs in flight a
    CTA within 200 KiB of shared memory, 1 to SPEC rounds an iteration,
    and a distance row a query of min(spec
    round_k, N) floats; the chain route, where 8 warps' rows of floats fit
    200 KiB (chain_fits: every r to L 6,400, r <= 3,072 at any L), 8
    warps a CTA."""
    assert kdtw.spread_fits(L, L - 1) == (L <= 25600)
    assert kdtw.chain_fits(L, L - 1) == (L <= 6400)
    for r in range(0, L, 1 if L <= 1024 else 7):
        rows = kdtw.diag_rows(r)
        cols = min(L, 2 * r + 32 * rows)
        for Qg, N, rk in ((1, 1, 1), (4, 256, 32), (32, 1 << 16, 32),
                          (8, 5000, 2048), (40, 1000, 16)):
            g = kdtw.spread_search_geometry(Qg, N, L, r, rk)
            assert g["rows"] == rows and g["width"] == cols
            assert g["strips"] == -(-L // (32 * rows))
            assert 1 <= g["slots"] <= 16
            assert g["smem"] == 8 * g["slots"] * g["width"] <= 200 * 1024
            assert 1 <= g["spec"] <= min(kdtw.SPEC, -(-N // rk))
            assert g["wdist"] == min(g["spec"] * rk, N)
        c = kdtw.chain_scan_geometry(L, r)
        assert c["width"] == cols and c["threads"] == 256
        assert (c["smem"] <= 200 * 1024) == kdtw.chain_fits(L, r)


@pytest.mark.parametrize("N", [0, 1, 100, 256, 1 << 16])
def test_spread_spec_and_chain_pairs(N):
    """spread_spec: SPEC rounds an iteration, the search's rounds where
    fewer (one at a round past N); the scan takes the chain route past r
    255 from CHAIN_PAIRS pairs (the full window's 4 x 256 and up), diag
    below and where a warp's row does not fit."""
    assert kdtw.SPEC == 8 and kdtw.CHAIN_PAIRS == 1024
    for rk in (1, 16, 32, 1024, 2048, 1 << 20):
        assert kdtw.spread_spec(N, rk) == max(1, min(8, -(-N // rk)))
    Q = max(1, -(-kdtw.CHAIN_PAIRS // max(N, 1)))
    for L, r in ((1024, 256), (1024, 1023), (2709, 271), (8192, 819)):
        assert kdtw.scan_route(r, L, Q, N) == (
            "chain" if Q * N >= 1024 else "diag")
        assert kdtw.scan_route(r, L, 1, N) == (
            "chain" if N >= 1024 else "diag")
    assert kdtw.scan_route(3073, 60000, 32, 1 << 16) == "diag"


_POISON = np.float32(1e20)


def _scan_warp(q, xs, r, cells):
    """One warp of csrc/dtw.cu's scan_wave_kernel, lane by lane in numpy
    float32: query q (L,) against the tile's series xs (n <= P, L), laid
    out by scan_geometry with the kernel's pads, each lane's steps j = 0
    .. L - 1 (its window xp[j + m], its query row qp[j]), the two
    shuffles (lane 0 reading lane 31's last cell; lane 31's up its own),
    the top lane's forced left at cell ML and up at its last cell, and
    cell (0, 0)'s diag 0 on the live lanes only.  Returns each pair's
    cell (L - 1, r), on its lane l0."""
    C, L = cells, q.shape[0]
    g = kdtw.scan_geometry(L, r, C, 1)
    H, P, pad, S, Lq = (g[k] for k in ("lanes", "pairs", "pad", "stride",
                                       "qstride"))
    l0, m0 = r // C, r % C
    ML = 2 * r + 1 - C * (H - 1)
    assert ML % 2 == 1 and 1 <= ML < C
    big = np.float32(ref.BIG)
    tile = np.full(pad + P * S, -_POISON, np.float32)
    for p in range(xs.shape[0]):
        tile[pad + p * S:pad + p * S + L] = xs[p]
    qrow = np.full(Lq, _POISON, np.float32)
    qrow[H:H + L] = q
    lane = np.arange(32)
    slot, ll = lane // H, lane % H
    live = slot < P
    top = live & (ll == H - 1)
    xp = pad + np.minimum(slot, P - 1) * S + l0 + (C - 1) * ll - r
    qp = H + l0 - ll
    v = np.full((32, C), big, np.float32)
    v[live & (ll == l0), m0] = 0
    with np.errstate(over="ignore"):
        for j in range(L):
            assert ((qp + j >= 0) & (qp + j < Lq)).all()
            at = xp[:, None] + j + np.arange(C)
            assert ((at >= 0) & (at < tile.size)).all()
            t = qrow[qp + j][:, None] - tile[at]
            v = _wave_step(v, t * t, top, ML)
    return v[np.arange(xs.shape[0]) * H + l0, m0]


def _wave_step(v, d, top, ML):
    """One step of a warp's 32 lanes (csrc/dtw.cu wave_cells): v (32, C)
    their cells of the last step, d (32, C) this step's squared
    differences; cell 0's left the lane below's last cell (lane 0 reading
    lane 31), the last cell's up the lane above's cell 0 of this step
    (lane 31 its own), on a `top` lane the left of cell ML and that up
    BIG.  Returns this step's cells."""
    C, lane, big = v.shape[1], np.arange(32), np.float32(ref.BIG)
    nv = np.empty_like(v)
    left = v[(lane + 31) % 32, C - 1]
    nv[:, 0] = d[:, 0] + np.fmin(np.fmin(v[:, 0], v[:, 1]), left)
    up = np.where(top, big, np.append(nv[1:, 0], nv[31, 0]))
    for m in range(1, C):
        lft = np.where(top, big, nv[:, m - 1]) if m == ML else nv[:, m - 1]
        u = v[:, m + 1] if m + 1 < C else up
        nv[:, m] = d[:, m] + np.fmin(np.fmin(v[:, m], u), lft)
    return nv


@pytest.mark.parametrize("r", [0, 1, 3, 12, 17, 25, 40, 127, 254, 255])
@pytest.mark.parametrize("L", [1, 7, 100, 300])
def test_scan_wave_program_equals_the_band(r, L):
    """The wave route's lane program (_scan_warp: no edge tests, a cell
    past an edge infinite by the pads, the first step at cell (0, 0)'s
    wavefront, the cells past the band held at BIG or more by two forced
    operands, idle lanes and a tile short of P series) gives dtw_band_ref's
    bits for every pair, at radii across the route's range, both ends
    included (r clamped to L - 1, as the wrapper does)."""
    C = kdtw.SCAN_CELLS["wave16"]
    rng = np.random.default_rng(1000 * r + L)
    r = min(r, L - 1)
    P = kdtw.scan_geometry(L, r, C, 1)["pairs"]
    for n in sorted({P, max(1, P - 1)}):
        q = np.cumsum(rng.standard_normal(L)).astype(np.float32)
        xs = np.cumsum(rng.standard_normal((n, L)), 1).astype(np.float32)
        want = ref.dtw_band_ref(_t(q)[None], _t(xs), r).numpy()
        assert np.array_equal(_scan_warp(q, xs, r, C), want), (r, n)


class _Ring:
    """A pair's ring of columns on a ring route (csrc/dtw.cu: dtw_wave's
    and scan_pair_ring's `ensure`), in numpy: W = ring_size(cells, lanes)
    slots, column c in slot c & (W - 1), fills of RING_CHUNK columns with
    one in flight, a fill landing only at the next `ensure` that waits.
    `read` asserts a slot holds the column asked for and no fill in
    flight targets it, and returns the value there."""

    def __init__(self, series, cells, lanes, first, last, poison=None):
        self.x, self.first, self.last = series, first, last
        self.W = kdtw.ring_size(cells, lanes)
        self.held = np.full(self.W, np.iinfo(np.int64).min)
        self.val = np.zeros(self.W, np.float32)
        self.poison = poison
        self.ready = self.hi = first
        self.flight = []
        self.reads = 0

    def ensure(self, col):
        col = min(col, self.last)
        while self.ready <= col:
            for c in self.flight:                    # cp.async.wait_group 0
                self.held[c % self.W] = c
                inside = 0 <= c < len(self.x)
                self.val[c % self.W] = self.x[c] if inside else self.poison
            self.flight = []
            self.ready = self.hi
            if self.hi <= self.last:
                self.flight = [c for c in range(self.hi,
                                                self.hi + kdtw.RING_CHUNK)
                               if self.poison is not None
                               or 0 <= c < len(self.x)]
                self.hi += kdtw.RING_CHUNK

    def read(self, cols):
        cols = np.asarray(cols)
        slots = cols % self.W
        assert (self.held[slots] == cols).all(), "a column not yet landed"
        busy = {c % self.W for c in self.flight}
        assert not busy & set(slots.tolist()), "a slot with a fill in flight"
        self.reads += cols.size
        return self.val[slots]


def _scan_ring_reads(x, r, cells=16):
    """scan_pair_ring's reads of one pair's series x (L,), step by step
    (steps in blocks of `cells`, `ensure` before each block, each lane's
    one new column a step after its first cells - 1), held to the values
    the staged tile's row gives at the same place (x, -poison past its
    ends): the ring's reads equal the whole row's."""
    L, C = len(x), cells
    H = -(-(2 * r + 1) // C)
    l0 = r // C
    c_lo, reach = l0 - r, (C - 1) * (H - 1) + C - 1
    ring = _Ring(x, C, H, c_lo, L - 1 + c_lo + reach, poison=-_POISON)
    cl = l0 + (C - 1) * np.arange(H) - r
    pad = max(r - l0, l0 + C * H - H - r, 0)
    row = np.full(pad + L + pad + C, -_POISON, np.float32)
    row[pad:pad + L] = x

    def whole(cols):
        return row[pad + cols]

    ring.ensure(c_lo + reach)
    for m in range(C - 1):
        assert np.array_equal(ring.read(cl + m), whole(cl + m))
    for j0 in range(0, L, C):
        ring.ensure(min(j0 + C - 1, L - 1) + c_lo + reach)
        for j in range(j0, min(j0 + C, L)):
            cols = cl + j + C - 1
            assert np.array_equal(ring.read(cols), whole(cols))
    return ring.reads


def _wave_ring_reads(x, r, cells):
    """dtw_wave's reads of one pair's series x (L,) on a ring route, in
    its loop order (the edge steps one at a time, the middle in blocks of
    8, `ensure` before each), each lane's cells inside the band and the
    series: the ring's reads equal x at those columns."""
    L, C = len(x), cells
    H = -(-(2 * r + 1) // C)
    l0 = r // C
    reach = (C - 1) * (H - 1) + C - 1 - r
    ring = _Ring(x, C, H, 0, L - 1)
    end = L + l0
    a = min(max(H, r), end)
    b = max(a, min(min(L - r + 2 * r // C, L), end - 1))
    ll = np.arange(H)[:, None]
    m = np.arange(C)[None]
    band = (C * ll + m <= 2 * r)

    def step(s):
        rows = s - ll
        cols = s + (C - 1) * ll - r + m
        take = band & (rows >= 0) & (rows < L) & (cols >= 0) & (cols < L)
        assert np.array_equal(ring.read(cols[take]), x[cols[take]])

    s = 0
    while s < end:
        n = 8 if a <= s and s + 8 <= b else 1
        ring.ensure(s + n - 1 + reach)
        for u in range(n):
            step(s + u)
        s += n
    return ring.reads


@pytest.mark.parametrize("L", [1025, 2709, 8192])
def test_ring_windows_read_what_the_whole_rows_read(L):
    """The ring routes' column windows (L > 1024: dtw_search's ring2 /
    ring4 / ring8, dtw_scan's ring routes at 16 cells a lane and at the
    width each radius takes) at lengths past what a block stages whole:
    every column a lane reads has landed in its slot and is not being
    overwritten, and equals the whole row's value there, for radii across
    each route's range; the rings are those ring_size gives, a few KB,
    whatever L."""
    rng = np.random.default_rng(L)
    x = rng.standard_normal(L).astype(np.float32)
    for r in (17, 27, 81, 135, 255):
        for C in sorted({16, kdtw.scan_ring_cells(r)}):
            assert _scan_ring_reads(x, r, C) >= L
            H = -(-(2 * r + 1) // C)
            assert kdtw.ring_size(C, H) <= 1024
    for route, rs in (("ring2", (0, 12, 27, 31)), ("ring4", (40, 63)),
                      ("ring8", (81, 127)), ("ring16", (128, 135, 255))):
        for r in rs:
            assert kdtw.dp_route(r, L) == route
            assert _wave_ring_reads(x, r, kdtw.wave_cells(route)) > 0


def _scan_ring_warp(q, xs, r, cells):
    """One warp of csrc/dtw.cu's scan_ring_kernel (L > 1024), lane by lane
    in numpy float32: query q (L,) from device memory (+poison outside [0,
    L)) against the tile's series xs (n <= P, L), each pair's columns
    through its own ring (_Ring: -poison outside [0, L), `ensure` before
    each block of `cells` steps; idle lanes read the last pair's ring and
    slots past n the last series, as the kernel's clamps do), the cells of
    _wave_step.  Returns each series' cell (L - 1, r), on its lane l0."""
    C, L, n = cells, q.shape[0], xs.shape[0]
    H, P = kdtw.scan_lanes(r, C)
    l0, m0 = r // C, r % C
    ML = 2 * r + 1 - C * (H - 1)
    assert ML % 2 == 1 and 1 <= ML < C
    lane = np.arange(32)
    slot, ll = lane // H, lane % H
    live = slot < P
    top = live & (ll == H - 1)
    c_lo, reach = l0 - r, (C - 1) * (H - 1) + C - 1
    rings = [_Ring(xs[min(p, n - 1)], C, H, c_lo, L - 1 + c_lo + reach,
                   poison=-_POISON) for p in range(P)]
    pair = np.minimum(slot, P - 1)
    cl = l0 + (C - 1) * ll - r
    qpad = np.concatenate([np.full(H + r, _POISON, np.float32), q,
                           np.full(H + r, _POISON, np.float32)])

    def ensure(j_last):
        for ring in rings:
            ring.ensure(min(j_last, L - 1) + c_lo + reach)

    def window(cols):                 # (32, k) columns -> their values
        out = np.empty(cols.shape, np.float32)
        for p, ring in enumerate(rings):
            at = pair == p
            out[at] = ring.read(cols[at].ravel()).reshape(cols[at].shape)
        return out
    v = np.full((32, C), np.float32(ref.BIG), np.float32)
    v[live & (ll == l0), m0] = 0
    with np.errstate(over="ignore"):
        for j0 in range(0, L, C):
            ensure(j0 + C - 1)
            for j in range(j0, min(j0 + C, L)):
                qi = qpad[H + r + j + l0 - ll]
                t = qi[:, None] - window(cl[:, None] + j + np.arange(C))
                v = _wave_step(v, t * t, top, ML)
    return v[np.arange(n) * H + l0, m0]


@pytest.mark.parametrize("r", [17, 27, 40, 81, 135, 200, 255])
def test_scan_ring_program_equals_the_band(r):
    """The ring route's lane program at the cells a lane its radius takes
    (scan_ring_cells: 18 at r 17 and 135, 22 at r 40 and 81, 16 at r 27,
    200 and 255) and at 16 (the layout before the widths), past L 1,024:
    every pair's cell (L - 1, r) has dtw_band_ref's bits, for a full tile
    of P series and one short of it (a slot past the collection)."""
    L = 1031
    rng = np.random.default_rng(r)
    q = np.cumsum(rng.standard_normal(L)).astype(np.float32)
    for C in sorted({kdtw.scan_ring_cells(r), 16}):
        P = kdtw.scan_lanes(r, C)[1]
        for n in sorted({P, max(1, P - 1)}):
            xs = np.cumsum(rng.standard_normal((n, L)), 1).astype(np.float32)
            want = ref.dtw_band_ref(_t(q)[None], _t(xs), r).numpy()
            assert np.array_equal(_scan_ring_warp(q, xs, r, C), want), \
                (r, C, n)


def test_ring_widths_compute_each_band_cell_once():
    """For every r in 17-255 at L > 1,024, the ring route's geometry
    (scan_ring_cells, scan_lanes, scan_geometry): a pair's lanes hold
    band offset k as lane k // C's cell k % C and, over the kernel's
    steps j = 0 .. L - 1, form row j + l0 - ll on lane ll, so every band
    cell of the matrix is formed exactly once a pair; the cells past the
    band lie on the top lane only (ML .. C - 1); at least 25 of a warp's
    32 lanes are busy (30.5 on average); the pairs' rings fit the CTA's
    shared memory."""
    L = 1100
    busy = []
    for r in range(17, 256):
        C = kdtw.scan_ring_cells(r)
        H, P = kdtw.scan_lanes(r, C)
        l0 = r // C
        assert C in kdtw.SCAN_RING_WIDTHS and H * P <= 32
        assert C * (H - 1) < 2 * r + 1 <= C * H       # the top lane in it
        busy.append(H * P)
        g = kdtw.scan_geometry(L, r, C, 32)
        assert (g["lanes"], g["pairs"]) == (H, P)
        assert g["smem"] == 4 * (g["threads"] // 32) * P * g["stride"] \
            <= 200 * 1024
        ll, m = np.meshgrid(np.arange(H), np.arange(C), indexing="ij")
        k = (C * ll + m).ravel()
        band = k <= 2 * r
        assert band.sum() == 2 * r + 1 and len(set(k)) == H * C
        assert (~band == ((ll.ravel() == H - 1)
                          & (m.ravel() >= 2 * r + 1 - C * (H - 1)))).all()
        j = np.arange(L)[:, None]
        i = j + l0 - ll.ravel()[None]                  # the row a step
        c = i - r + k[None]
        inside = (i >= 0) & (i < L) & (c >= 0) & (c < L) & band[None]
        cells = (i[inside] * (2 * r + 1) + k[None].repeat(L, 0)[inside])
        assert len(np.unique(cells)) == cells.size == _band_cells(L, r)
    assert min(busy) >= 25 and np.mean(busy) >= 30.5


def _band_cells(L, r):
    """Cells of an L x L matrix within the band |i - c| <= r."""
    return sum(min(L - 1, i + r) - max(0, i - r) + 1 for i in range(L))


@pytest.mark.parametrize("rows", [1, 2, 4, 8])
@pytest.mark.parametrize("L", [1, 2, 7, 31, 33, 64, 100, 256, 300])
def test_strip_model_equals_the_band(L, rows):
    """The diag routes' strip program (ref.dtw_strip_ref: strips of 32
    rows rows, each a skewed wavefront over a warp's lanes, a strip's last
    row handed on through an explicit buffer of tagged entries at the
    kernel's offsets, every read of it checked) gives dtw_band_ref's bits
    at every radius to past the series, strip heights that divide L (L 64
    and 256) and that do not, and repro's dtw_band within the tolerance of
    the tests above; its chunks run inner (no tests), plain and with every
    test (`counts`), as the kernel's do."""
    rng = np.random.default_rng(L * 10 + rows)
    counts = {}
    for r in sorted({0, 1, 12, L // 2, L - 1, L + 5}):
        q, x = (rng.standard_normal((2, L)).astype(np.float32)
                for _ in range(2))
        got = ref.dtw_strip_ref(_t(q), _t(x), r, rows, counts=counts)
        want = ref.dtw_band_ref(_t(q), _t(x), min(r, L - 1))
        assert got.numpy().tobytes() == want.numpy().tobytes()
        if rows == 4:
            jr = np.array([float(J.dtw_band(jnp.asarray(a), jnp.asarray(b),
                                            min(r, L - 1)))
                           for a, b in zip(q, x)])
            np.testing.assert_allclose(got.numpy(), jr, rtol=1e-5)
    assert counts["rare"] > 0
    if L >= 100:
        assert counts["plain"] > 0
    if L >= 256:
        assert counts["inner"] > 0


def _strip_schedule(L, r, rows, rng):
    """The diag routes' hand-over of strip rows (csrc/dtw.cu strip_dp) run
    in a random order of chunks: every strip of a pair live at once (as
    many warps), each step a random strip among those whose chunk can
    start, i.e. every entry of the strip above it reads there (the columns
    j0 .. j0 + 31 of that strip's span, and at the first chunk lo - 1)
    carries that strip's tag; then the chunk's 32 steps store lane 31's
    columns lo .. hi (tag s + 1, at column - lo) into the pair's one row,
    over the strip above's entries.  Returns the chunks run; asserts that
    no order deadlocks, i.e. that no strip rewrites an entry that the
    strip below it has yet to read, and that no step stores past its
    strip's columns: where two strips start at the same column, a store
    past the upper one's last column would land on the lower one's own
    entries, which it may write first (it needs none of the upper one's
    columns there), and leave them a stale tag."""
    S = 32 * rows
    strips = -(-L // S)
    width = kdtw.diag_width(L, r, rows)
    tag = np.zeros(width, np.int64)

    def span(s0):
        return max(0, s0 - r), min(L - 1, s0 + S - 1 + r)
    nxt = []                                # each strip's next chunk
    for s in range(strips):
        lo, hi = span(s * S)
        nxt.append(lo)
    runs = 0
    while True:
        ready = []
        for s in range(strips):
            lo, hi = span(s * S)
            j0 = nxt[s]
            if j0 > hi + 31:
                continue
            if s > 0:
                ilo, ihi = span(s * S - S)
                need = [c for c in range(j0, j0 + 32) if ilo <= c <= ihi]
                if j0 == lo and ilo <= lo - 1 <= ihi:
                    need.append(lo - 1)
                if not all(tag[c - ilo] == s for c in need):
                    continue
            ready.append(s)
        if not ready:
            break
        s = ready[rng.integers(len(ready))]
        lo, hi = span(s * S)
        j0 = nxt[s]
        if s + 1 < strips:
            for c in range(max(lo, j0 - 31), min(hi, j0) + 1):
                assert 0 <= c - lo < width
                tag[c - lo] = s + 1
        nxt[s] = j0 + 32
        runs += 1
    assert all(nxt[s] > span(s * S)[1] + 31 for s in range(strips)), nxt
    return runs


@pytest.mark.parametrize("rows", [1, 4])
@pytest.mark.parametrize("L,r", [(300, 0), (300, 12), (300, 40),
                                 (300, 150), (300, 299), (1000, 100),
                                 (1000, 200)])
def test_strips_hand_on_rows_in_any_order(L, r, rows):
    """The strip rows' hand-over (_strip_schedule) finishes under 20
    random orders of chunks: no strip waits on an entry that a strip
    below has already rewritten (one row a pair, each strip writing over
    the entries it has read), at narrow and wide bands, the matrix's ends
    included."""
    rng = np.random.default_rng(L + r + rows)
    for _ in range(20):
        assert _strip_schedule(L, r, rows, rng) > 0


# ------------------------------------------- the chain and spread routes
# the radii the general routes took before: r 128, 255 and 256 (where the
# strips go from 4 to 8 rows a lane), 512 and the full window, L - 1
HAND_RADII = (128, 255, 256, 512, "full")
HAND_LENGTHS = (7, 300, 1024, 2709)


def _hand_shapes():
    for L in HAND_LENGTHS:
        for r in sorted({L - 1 if r == "full" else min(r, L - 1)
                         for r in HAND_RADII}):
            yield L, r


@pytest.mark.parametrize("L,r", list(_hand_shapes()))
def test_chain_hand_over_equals_the_band(L, r):
    """dtw_scan's chain route (csrc/dtw.cu scan_chain): one warp runs a
    pair's strips in order through its own row of plain floats in shared
    memory, each strip reading an entry once (the next chunk's ahead of
    it) and writing over entries it has read: ref.dtw_strip_ref with
    hand "warp" asserts that every entry read then holds the strip
    above's value, and gives dtw_band_ref's bits at the rows a lane of
    the route (diag_rows)."""
    rng = np.random.default_rng(L + 7 * r)
    q, x = (rng.standard_normal((2, L)).astype(np.float32)
            for _ in range(2))
    got = ref.dtw_strip_ref(_t(q), _t(x), r, kdtw.diag_rows(r),
                            hand="warp")
    want = ref.dtw_band_ref(_t(q), _t(x), r)
    assert got.numpy().tobytes() == want.numpy().tobytes()


@pytest.mark.parametrize("L,r", list(_hand_shapes()))
def test_spread_strips_hand_on_rows_in_any_order(L, r):
    """dtw_search's spread route: a pair's strips on the warps of one CTA,
    their rows handed on through tagged entries in its shared memory (as
    the diag routes' in device scratch), each chunk run in a random order
    among the strips whose entries carry the tags they need: no order
    deadlocks and every one gives dtw_band_ref's bits; then the slot's
    next pair through the same row (its tags after the first pair's, the
    row not cleared) the same."""
    rng = np.random.default_rng(3 * L + r)
    rows = kdtw.diag_rows(r)
    q, x = (rng.standard_normal((2, 2, L)).astype(np.float32)
            for _ in range(2))
    want = ref.dtw_band_ref(_t(q), _t(x), r).numpy()
    strips = kdtw.diag_strips(L, rows)
    for _ in range(2 if L < 2709 else 1):
        row = ref.StripRow(2, kdtw.diag_width(L, r, rows))
        for b in range(2 if L < 2709 else 1):
            got = ref.dtw_strip_ref(_t(q[b]), _t(x[b]), r, rows, rng=rng,
                                    row=row, base=b * strips)
            assert got.numpy().tobytes() == want[b].tobytes()


def _spread_rounds(sorted_lb, order, d_pairs, round_k, spec, per):
    """dtw_search's spread route's loop (csrc/dtw.cu search_spread) for
    each query, over given pair distances: an iteration takes every
    candidate of its window of spec round_k positions whose bound lies
    below the best-so-far of its start (position j by CTA j % per), then
    applies the spec rounds in order as the loop of single rounds: the
    stop before each, the candidates below the best-so-far of the moment
    (each asserted computed), their first minimum.  Returns (bsf, best,
    rounds, refined, distances computed) a query."""
    big = np.float32(ref.BIG)
    out = []
    for lb, ord_, dq in zip(sorted_lb.numpy(), order.numpy(),
                            d_pairs.numpy()):
        N = len(lb)
        W = spec * round_k
        end = -(-N // round_k) * round_k
        bsf, best, rounds, refined, done = big, -1, 0, 0, 0
        go = end > 0 and lb[0] < bsf
        cursor = 0
        while go:
            here = min(W, N - cursor)
            have = {}
            for c in range(per):
                for j in range(c, here, per):
                    if lb[cursor + j] < bsf:
                        have[j] = dq[ord_[cursor + j]]
            done += len(have)
            on = True
            for u in range(spec):
                cu = cursor + u * round_k
                if u > 0:
                    on = on and cu < end and lb[cu] < bsf
                if not on:
                    break
                key, nt = (big, round_k), 0
                for j in range(round_k):
                    pos = cu + j
                    if pos < N and lb[pos] < bsf:
                        key = min(key, (have[pos - cursor], j))
                        nt += 1
                if key[0] < bsf:
                    bsf, best = key[0], int(ord_[cu + key[1]])
                rounds += 1
                refined += nt
            cursor += W
            go = on and cursor < end and lb[cursor] < bsf
        out.append((float(bsf), best, rounds, refined, done))
    return out


@pytest.mark.parametrize("N,rk,spec,per,noise", [
    (300, 32, 8, 33, 0.3), (300, 32, 1, 4, 0.3), (301, 16, 3, 5, 0.5),
    (200, 7, 8, 2, 0.2), (37, 64, 8, 3, 0.4), (500, 5, 2, 1, 0.6)])
def test_spread_rounds_equal_the_loop_of_rounds(N, rk, spec, per, noise):
    """The spread route's speculative iterations (_spread_rounds) give
    dtw_search_ref's bsf, id, rounds and candidates refined whatever the
    rounds an iteration (spec) and the CTAs a query (per); every distance
    a round reads was computed at its iteration's start, and the
    iterations compute at least the loop's candidates."""
    rng = np.random.default_rng(N + rk + spec)
    L, r, Q = 48, 6, 4
    x = isax.znormalize(torch.as_tensor(
        np.cumsum(rng.standard_normal((N, L)), 1), dtype=torch.float32))
    q = x[torch.as_tensor(rng.integers(0, N, Q))] + noise * torch.as_tensor(
        rng.standard_normal((Q, L)), dtype=torch.float32)
    s, o = torch.sort(ref.lb_keogh_ref(q, x, r), dim=1, stable=True)
    dp = ref.dtw_band_ref(q[:, None], x[None], r)
    want = ref.dtw_search_ref(q, x, s, o, r, rk, d_pairs=dp)
    got = _spread_rounds(s, o, dp, rk, spec, per)
    assert [g[:4] for g in got] == list(zip(*(w.tolist() for w in want)))
    assert all(g[4] >= g[3] for g in got)
    if spec == 1:
        assert all(g[4] == g[3] for g in got)


@pytest.mark.parametrize("r", [0, 7, 17, 25, 51, 102, 127, 200, 255])
def test_wavefront_model_at_16_cells_equals_the_band(r):
    """ref.dtw_wavefront_ref at the scan's widest route, 16 cells a lane,
    up to its largest radius: dtw_band_ref's bits (at L 300 r 255 too)."""
    rng = np.random.default_rng(r)
    for L in (7, 100) + ((300,) if r == 255 else ()):
        q, x = (rng.standard_normal((2, L)).astype(np.float32)
                for _ in range(2))
        assert torch.equal(ref.dtw_wavefront_ref(_t(q), _t(x), r, 16),
                           ref.dtw_band_ref(_t(q), _t(x), r))


@pytest.mark.parametrize("L", [1, 2, 5, 16, 40])
def test_band_past_the_series_is_the_whole_matrix(L):
    """dtw_band_ref and the envelope at r >= L - 1 have the bits of r = L -
    1 (every column of every row is in the band), so the wrappers' clamp
    changes no answer; the wrappers on the CPU answer so at any r."""
    rng = np.random.default_rng(L)
    q, x = (np.cumsum(rng.standard_normal((3, L)), 1).astype(np.float32)
            for _ in range(2))
    want = ref.dtw_band_ref(_t(q), _t(x), L - 1)
    lo, hi = ref.dtw_envelope(_t(q), L - 1)
    for r in (L, 2 * L, 900):
        assert torch.equal(ref.dtw_band_ref(_t(q), _t(x), r), want)
        rlo, rhi = ref.dtw_envelope(_t(q), r)
        assert torch.equal(rlo, lo) and torch.equal(rhi, hi)
        d2, i = kdtw.dtw_scan(_t(q), _t(x), r=r)
        assert torch.equal(d2, ref.dtw_scan_ref(_t(q), _t(x), L - 1)[0])
        assert torch.equal(kdtw.lb_keogh(_t(q), _t(x), r=r),
                           ref.lb_keogh_ref(_t(q), _t(x), L - 1))


@pytest.mark.parametrize("N,L,Q,r,round_k", [
    (40, 16, 2, 900, 32),        # the band past the series
    (37, 16, 3, 15, 8),          # r = L - 1
    (60, 256, 2, 128, 256),      # a round of 256 (the spread route)
    (70, 256, 2, 200, 1024),     # ... of 1024
    (50, 256, 3, 128, 32),       # the spread and chain routes' radii
    (45, 300, 2, 255, 16),
    (40, 600, 2, 512, 32),
])
def test_wide_bands_answer_as_repro(N, L, Q, r, round_k):
    """Wide bands (past the wave routes' radii: the spread and chain
    routes on the card; r past the series) and wide rounds: the port's
    search_dtw and search_dtw_bruteforce on the CPU give repro's ids and
    its distances to 1e-5."""
    rng = np.random.default_rng(N + L + r)
    X = np.cumsum(rng.standard_normal((N, L)), axis=1).astype(np.float32)
    Qs = (X[rng.integers(0, N, Q)] + 0.3 * rng.standard_normal((Q, L))
          ).astype(np.float32)
    jd, ji = J.search_dtw(jnp.asarray(X), jnp.asarray(Qs), r=r,
                          round_k=round_k)
    jbd, jbi = J.search_dtw_bruteforce(jnp.asarray(X), jnp.asarray(Qs), r=r)
    for (d, i), (wd, wi) in (
            (T.search_dtw(X, Qs, r=r, round_k=round_k, device="cpu"),
             (jd, ji)),
            (T.search_dtw_bruteforce(X, Qs, r=r, device="cpu"),
             (jbd, jbi))):
        assert i.tolist() == np.asarray(wi).tolist()
        np.testing.assert_allclose(d.numpy(), np.asarray(wd), rtol=1e-5)


def test_clamp_excursion_has_the_bits_of_repros_form():
    """The LB_Keogh kernel's e = x - min(max(x, lo), hi) (csrc/dtw.cu,
    lb_keogh_kernel: 4 instructions a point with the FMA) squares to the
    bits of the form it replaced (and lb_keogh_ref's), max(x - hi, lo -
    x, 0)^2 (5), and of repro's max(x - hi, 0)^2 + max(lo - x, 0)^2:
    above, below and inside the envelope, x exactly at lo and at hi, +-0
    in every operand, an envelope of one point (lo == hi), and values a
    rounding apart."""
    rng = np.random.default_rng(5)
    lo = rng.standard_normal(4000).astype(np.float32)
    hi = lo + np.abs(rng.standard_normal(4000)).astype(np.float32)
    hi[:500] = lo[:500]
    x = (rng.standard_normal(4000) * 2).astype(np.float32)
    x[500:700], x[700:900] = lo[500:700], hi[700:900]
    x[900:1000] = np.nextafter(lo[900:1000], np.float32(-np.inf))
    x[1000:1100] = np.nextafter(hi[1000:1100], np.float32(np.inf))
    zeros = np.array([0.0, -0.0], np.float32)
    for a, b, c in itertools.product(zeros, repeat=3):
        if not b > c:                   # lo <= hi: +-0 in any order
            x, lo, hi = (np.append(x, a), np.append(lo, b),
                         np.append(hi, c))
    x, lo, hi = _t(x), _t(lo), _t(hi)
    e = x - torch.minimum(torch.maximum(x, lo), hi)
    old = torch.maximum(x - hi, lo - x).clamp_min(0.0)
    assert torch.equal((e * e).view(torch.int32),
                       (old * old).view(torch.int32))
    # repro's own term a point (src/repro/core/dtw.py, lb_keogh)
    jx, jlo, jhi = (jnp.asarray(a.numpy()) for a in (x, lo, hi))
    above, below = jnp.maximum(jx - jhi, 0.0), jnp.maximum(jlo - jx, 0.0)
    np.testing.assert_array_equal(
        (e * e).view(torch.int32).numpy(),
        np.asarray(above * above + below * below).view(np.int32))


# --------------------------------------------- isax's distance helpers
def _pruning_inputs(walks, queries):
    x = isax.znormalize(torch.as_tensor(walks[:256], dtype=torch.float32))
    q = isax.znormalize(torch.as_tensor(queries[:1], dtype=torch.float32))
    return x, q


def test_euclidean_helpers_equal_repros(walks, queries):
    x, q = _pruning_inputs(walks, queries)
    jx, jq = jnp.asarray(x.numpy()), jnp.asarray(q.numpy())
    np.testing.assert_allclose(isax.euclidean_sq(q, x).numpy(),
                               np.asarray(jisax.euclidean_sq(jq, jx)),
                               rtol=1e-5)
    np.testing.assert_allclose(isax.euclidean(q, x).numpy(),
                               np.asarray(jisax.euclidean(jq, jx)),
                               rtol=1e-5)


def test_paa_lb_and_mindist_equal_repros_and_bound_ed(walks, queries):
    x, q = _pruning_inputs(walks, queries)
    jx, jq = jnp.asarray(x.numpy()), jnp.asarray(q.numpy())
    p, w = isax.summarize(x)
    qp = isax.paa(q)
    jp, jw = jisax.summarize(jx)
    jqp = jisax.paa(jq)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    ed = isax.euclidean_sq(q, x).numpy()
    plb = isax.paa_lb_sq(qp, p, series_len=256).numpy()
    np.testing.assert_allclose(plb, np.asarray(
        jisax.paa_lb_sq(jqp, jp, series_len=256)), rtol=1e-5, atol=1e-5)
    lb = isax.mindist_isax_sq(qp, w, series_len=256).numpy()
    np.testing.assert_allclose(lb, np.asarray(
        jisax.mindist_isax_sq(jqp, jw, series_len=256)), rtol=1e-5,
        atol=1e-5)
    assert np.all(lb <= ed + 1e-3 * np.maximum(ed, 1.0))
    assert np.all(plb <= ed + 1e-3 * np.maximum(ed, 1.0))


@pytest.mark.parametrize("bits,segments", [(2, 4), (4, 8), (8, 16)])
def test_mindist_param_sweep_equals_repros(bits, segments):
    rng = np.random.default_rng(bits * segments)
    x = np.cumsum(rng.standard_normal((4, 64)), axis=1)
    q = np.cumsum(rng.standard_normal((1, 64)), axis=1)
    xz = isax.znormalize(torch.as_tensor(x, dtype=torch.float32))
    qz = isax.znormalize(torch.as_tensor(q, dtype=torch.float32))
    p, w = isax.summarize(xz, segments, bits)
    qp = isax.paa(qz, segments)
    lb = isax.mindist_isax_sq(qp, w, bits, bits, 64).numpy()
    jlb = np.asarray(jisax.mindist_isax_sq(
        jnp.asarray(qp.numpy()), jnp.asarray(w.numpy()), bits, bits, 64))
    np.testing.assert_allclose(lb, jlb, rtol=1e-5, atol=1e-6)
    ed = isax.euclidean_sq(qz, xz).numpy()
    assert np.all(lb <= ed + 1e-3 * np.maximum(ed, 1.0))


def test_mindist_at_reduced_depth_is_looser():
    rng = np.random.default_rng(3)
    x = isax.znormalize(torch.as_tensor(
        np.cumsum(rng.standard_normal((16, 256)), 1), dtype=torch.float32))
    q = isax.znormalize(torch.as_tensor(
        np.cumsum(rng.standard_normal((1, 256)), 1), dtype=torch.float32))
    _, w = isax.summarize(x)
    qp = isax.paa(q)
    prev = None
    for depth in (8, 4, 2, 1):
        lb = isax.mindist_isax_sq(qp, w, depth).numpy()
        jlb = np.asarray(jisax.mindist_isax_sq(
            jnp.asarray(qp.numpy()), jnp.asarray(w.numpy()), depth))
        np.testing.assert_allclose(lb, jlb, rtol=1e-5, atol=1e-6)
        if prev is not None:
            assert np.all(lb <= prev + 1e-5)
        prev = lb


# ------------------------------------------- every shape repro answers
def _walks(rng, N, L, Q, noise=0.1):
    X = np.cumsum(rng.standard_normal((N, L)), axis=1).astype(np.float32)
    Qs = (X[rng.integers(0, N, Q)] + noise * rng.standard_normal((Q, L))
          ).astype(np.float32)
    return X, Qs


@pytest.mark.parametrize("L", [1025, 1100, 2709])
@pytest.mark.parametrize("band", ["r3", "5%"])
def test_long_series_answer_as_repro(L, band):
    """Series past 1,024 points, which the kernels once refused (the UCR
    archive's longest are 2,709 and 2,844): both searches on the CPU give
    repro's ids (but at ties) and its distances to rtol 1e-5, at r 3 and
    at the UCR Suite's 5 % band."""
    r = 3 if band == "r3" else L // 20
    rng = np.random.default_rng(L + r)
    X, Qs = _walks(rng, 24, L, 3)
    jd, ji = J.search_dtw(jnp.asarray(X), jnp.asarray(Qs), r=r, round_k=8)
    d, i = T.search_dtw(X, Qs, r=r, round_k=8, device="cpu")
    _same_answers(d, i, jd, ji)
    jd, ji = J.search_dtw_bruteforce(jnp.asarray(X), jnp.asarray(Qs), r=r)
    d, i = T.search_dtw_bruteforce(X, Qs, r=r, device="cpu")
    _same_answers(d, i, jd, ji)


def test_a_round_past_1024_candidates_answers_as_repro():
    """round_k 2,048 (a round in two passes of 1,024 on the card) at L 64
    over 3,000 series: repro's ids and distances, and the rounds and
    candidates refined those of a round-by-round loop."""
    rng = np.random.default_rng(2048)
    X, Qs = _walks(rng, 3000, 64, 2)
    jd, ji = J.search_dtw(jnp.asarray(X), jnp.asarray(Qs), r=3,
                          round_k=2048)
    d, i = T.search_dtw(X, Qs, r=3, round_k=2048, device="cpu")
    _same_answers(d, i, jd, ji)
    q, x = isax.znormalize(_t(Qs)), isax.znormalize(_t(X))
    s, o = torch.sort(kdtw.lb_keogh(q, x, r=3), dim=1, stable=True)
    bsf, best, rounds, refined = kdtw.dtw_search(q, x, s, o, r=3,
                                                 round_k=2048)
    got = list(zip(bsf.tolist(), best.tolist(), rounds.tolist(),
                   refined.tolist()))
    assert got == _rounds_one_by_one(q, x, s, o, 3, 2048)


def test_more_queries_than_a_grid_dimension_answer_as_repro():
    """65,537 queries (one past the grid's y limit, which the scan's band
    route now strides over) at L 4 over 2 series: the brute force's ids
    and distances equal repro's."""
    rng = np.random.default_rng(65537)
    X = rng.standard_normal((2, 4)).astype(np.float32)
    Qs = rng.standard_normal((65537, 4)).astype(np.float32)
    jd, ji = J.search_dtw_bruteforce(jnp.asarray(X), jnp.asarray(Qs), r=1)
    d, i = T.search_dtw_bruteforce(X, Qs, r=1, device="cpu")
    _same_answers(d, i, jd, ji)


def test_plain_versions_read_given_pair_distances():
    """ref.dtw_search_ref and ref.dtw_scan_ref answer the same, bit for
    bit, from every pair's dtw_band_ref distance given (d_pairs) as from
    their own calls: chip_smoke.py gives one such call to both."""
    rng = np.random.default_rng(5)
    q = _t(rng.standard_normal((3, 20)).astype(np.float32))
    x = _t(rng.standard_normal((40, 20)).astype(np.float32))
    dp = ref.dtw_band_ref(q[:, None], x[None], 4)
    s, o = torch.sort(ref.lb_keogh_ref(q, x, 4), dim=1, stable=True)
    for rk in (1, 4, 7, 40):
        got = ref.dtw_search_ref(q, x, s, o, 4, rk, d_pairs=dp)
        want = ref.dtw_search_ref(q, x, s, o, 4, rk)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = ref.dtw_scan_ref(q, x, 4, d_pairs=dp)
    want = ref.dtw_scan_ref(q, x, 4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _band_by_gathers(q, x, r):
    """dtw_band_ref as it was written before its strided views: each
    wavefront's cells gathered by index from q, x and the padded last
    wavefront, the same operations on the same operands."""
    q, x = torch.broadcast_tensors(q, x)
    lead, L = q.shape[:-1], q.shape[-1]
    q, x = q.reshape(-1, L), x.reshape(-1, L)
    W = 2 * r + 1
    big = torch.full((q.shape[0], 1), ref.BIG, dtype=torch.float32)
    prev2 = prev1 = big.expand(-1, W).contiguous()
    for t in range(2 * (L - 1) + r + 1):
        k0 = max(t % 2, t - 2 * (L - 1), 2 * r - t)
        k1 = min(W - 1, t, 2 * (L - 1) + 2 * r - t)
        if (k0 - t) % 2:
            k0 += 1
        cur = big.expand(-1, W).clone()
        if k0 <= k1:
            ks = torch.arange(k0, k1 + 1, 2)
            i = (t - ks) // 2
            diff = q[:, i] - x[:, i - r + ks]
            d = diff * diff
            padded = torch.cat([big, prev1, big], dim=1)
            up, left = padded[:, ks + 2], padded[:, ks]
            v = d + torch.minimum(torch.minimum(prev2[:, ks], up), left)
            if t == r:
                v[:, (r - k0) // 2] = d[:, (r - k0) // 2]
            cur[:, ks] = v
        prev2, prev1 = prev1, cur
    return prev1[:, r].reshape(lead)


@pytest.mark.parametrize("L,r", [(1, 0), (2, 1), (5, 3), (7, 6), (100, 0),
                                 (100, 7), (100, 99), (256, 12),
                                 (300, 255)])
def test_band_ref_views_equal_the_gathers(L, r):
    """dtw_band_ref's strided views give the bits of the gathers it
    replaced, pairs by rows and broadcast."""
    rng = np.random.default_rng(31 * L + r)
    q, x = (_t(rng.standard_normal((4, L)).astype(np.float32))
            for _ in range(2))
    assert torch.equal(ref.dtw_band_ref(q, x, r), _band_by_gathers(q, x, r))
    assert torch.equal(ref.dtw_band_ref(q[:, None], x[None], r),
                       _band_by_gathers(q[:, None], x[None], r))
