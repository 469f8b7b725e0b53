"""DTW search of the port (repro_torch.core.dtw, the plain versions of
csrc/dtw.cu on the CPU) against repro's on the same seeded numpy inputs:
tests/test_dtw.py's cases on both packages, envelope and LB_Keogh,
banded DTW against repro's and the O(L^2) oracle, and both searches at
round_k 16 and 32, N not a multiple of round_k, N < round_k, r = 0 and
znorm=False: ids equal but where two distances lie within 1e-5 relative,
distances to rtol 1e-5.  Then isax's four distance helpers against
repro's on tests/test_isax.py's inputs.

Tolerances: the port sums LB_Keogh in another order than XLA (rtol 1e-5);
the DP repeats repro's arithmetic cell for cell, so banded DTW agrees to
float32 rounding of the z-normalization (rtol 1e-5); the oracle is
float64 (rtol 1e-5, repro's own)."""

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


def _rounds_one_by_one(q, x, s, o, r, rk):
    """The refinement's loop as its docstring states it: one query, one
    round and one DP call at a time."""
    Qg, N = s.shape
    out = []
    for g in range(Qg):
        bsf, best, rounds, refined, cursor = ref.BIG, -1, 0, 0, 0
        bsf = np.float32(bsf)
        while cursor < N and float(s[g, cursor]) < bsf:
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
    chunk (max_pairs down to one round)."""
    rng = np.random.default_rng(N + L + rk)
    x = isax.znormalize(torch.as_tensor(
        np.cumsum(rng.standard_normal((N, L)), 1), dtype=torch.float32))
    q = x[torch.as_tensor(rng.integers(0, N, Q))] + noise * torch.as_tensor(
        rng.standard_normal((Q, L)), dtype=torch.float32)
    s, o = torch.sort(ref.lb_keogh_ref(q, x, r), dim=1, stable=True)
    bsf, best, rounds, refined = ref.dtw_search_ref(q, x, s, o, r, rk,
                                                    max_pairs=max_pairs)
    got = list(zip(bsf.tolist(), best.tolist(), rounds.tolist(),
                   refined.tolist()))
    assert got == _rounds_one_by_one(q, x, s, o, r, rk)
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


@pytest.mark.parametrize("L", [1, 100, 224, 225, 256, 257, 1024])
def test_routes_cover_every_length(L):
    assert kdtw.lb_route(L) == ("l256" if 224 < L <= 256 else "general")
    assert 1 <= kdtw.lb_group(L) <= kdtw.GROUP
    assert kdtw.lb_group(L) * 8 * L <= 200 * 1024


def test_dp_routes():
    assert [kdtw.dp_route(r) for r in (0, 12, 16, 17, 40)] == \
        ["band"] * 3 + ["general"] * 2


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
