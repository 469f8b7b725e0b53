"""The port's kernel modules against repro's Pallas kernels (interpret
mode), on the same numpy inputs.

On the CPU each wrapper runs its plain version; the CUDA kernels are held
against the same plain versions on the card by chip_smoke.py.  Tolerances:
PAA and lower bounds at rtol/atol 1e-5 (float32 sums in another order);
refine entry buffers equal, distances within 1e-5 * (q_sq + max |x|^2)
absolute (the matmul form cancels terms of that size).
"""

import shutil

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.kernels import ref as ref_j
from repro_torch.kernels import (_build, isax_summarize, lb_distance, ref,
                                 refine)

torch.set_num_threads(2)


def _walks(n, L=256, seed=0):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((n, L)), axis=1)
    x = (x - x.mean(1, keepdims=True)) / x.std(1, keepdims=True)
    return x.astype(np.float32)


# ---------------------------------------------------------------- summarize
@pytest.mark.parametrize("znorm", [False, True])
@pytest.mark.parametrize("n", [1, 7, 300])
def test_summarize_f32_matches_pallas(n, znorm):
    x = _walks(n, seed=n)
    pt, wt = isax_summarize.summarize(torch.from_numpy(x), znorm=znorm)
    pj, wj = ops.summarize(jnp.asarray(x), znorm=znorm, interpret=True)
    assert pt.dtype == torch.float32 and wt.dtype == torch.int32
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_summarize_bits_match_pallas(bits):
    x = _walks(50, seed=3)
    _, wt = isax_summarize.summarize(torch.from_numpy(x), bits=bits,
                                     znorm=False)
    _, wj = ops.summarize(jnp.asarray(x), bits=bits, znorm=False,
                          interpret=True)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    assert int(wt.max()) < (1 << bits)


def test_summarize_quantizes_a_breakpoint_as_the_plain_version():
    """A constant series z-normalizes to zeros, and 0.0 is the middle
    breakpoint at 8 bits: the port follows repro's summarize_ref
    (searchsorted side="right", symbol 128), where repro's Pallas kernel
    counts strictly smaller breakpoints (127)."""
    x = np.ones((2, 256), np.float32)
    _, wt = isax_summarize.summarize(torch.from_numpy(x))
    _, wr = ref_j.summarize_ref(jnp.asarray(x))
    _, wk = ops.summarize(jnp.asarray(x), interpret=True)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wr))
    assert (wt == 128).all() and (np.asarray(wk) == 127).all()


def test_summarize_bf16_moves_at_most_one_region():
    """bf16 rounding (~0.008 at |x| ~ 1) straddles 8-bit regions (~0.01
    wide near 0): a symbol may move to the neighbouring region only."""
    x = _walks(33, seed=5).astype(ml_dtypes.bfloat16)
    xt = torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    pt, wt = isax_summarize.summarize(xt)
    pj, wj = ops.summarize(jnp.asarray(x), interpret=True)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj, np.float32),
                               rtol=5e-2, atol=5e-2)
    diff = np.abs(wt.numpy() - np.asarray(wj))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.7


# -------------------------------------------------------------- lb_distance
@pytest.mark.parametrize("Q,NL", [(1, 16), (8, 129), (3, 7)])
def test_lb_distance_matches_pallas(Q, NL):
    rng = np.random.default_rng(Q * NL)
    qp = rng.standard_normal((Q, 16)).astype(np.float32)
    lo = (rng.standard_normal((NL, 16)) - 0.5).astype(np.float32)
    hi = lo + np.abs(rng.standard_normal((NL, 16))).astype(np.float32)
    lo[0, :4] = -np.inf                   # prefix regions at depth 0
    hi[0, 4:8] = np.inf
    lo[-1], hi[-1] = np.inf, np.inf       # an invalid (fully padded) leaf
    dt = lb_distance.lb_distance(torch.from_numpy(qp), torch.from_numpy(lo),
                                 torch.from_numpy(hi), series_len=256)
    dj = np.asarray(ops.lb_distance(jnp.asarray(qp), jnp.asarray(lo),
                                    jnp.asarray(hi), series_len=256,
                                    interpret=True))
    np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-5, atol=1e-5)
    assert np.isinf(dt[:, -1].numpy()).all()


# ------------------------------------------------------------------ refine
def _refine_inputs(Q, K, M, NL, L, k, alive_mode, seed):
    rng = np.random.default_rng(seed)
    series = _walks(NL * M, L, seed=seed)
    series[-3:] = 0.0                                  # padded rows
    sqn = (series * series).sum(1).astype(np.float32)
    sqn[-3:] = 1e30
    q = _walks(Q, L, seed=seed + 1)
    qsq = (q * q).sum(1).astype(np.float32)
    ids = np.stack([rng.permutation(NL)[:K] for _ in range(Q)]).astype(
        np.int32)
    alive = rng.integers(0, 2, (Q, K)).astype(bool)
    if alive_mode == "all_dead_row":
        alive[0] = False
    return series, sqn, q, qsq, ids, alive


def _run_both(series, sqn, q, qsq, ids, alive, bd, be, M, k, dtype):
    if dtype == "bf16":
        sj = jnp.asarray(series).astype(jnp.bfloat16)
        st = torch.from_numpy(series).to(torch.bfloat16)
    else:
        sj, st = jnp.asarray(series), torch.from_numpy(series)
    dj, ej = ops.refine_topk(jnp.asarray(q), jnp.asarray(qsq), sj,
                             jnp.asarray(sqn), jnp.asarray(ids),
                             jnp.asarray(alive), jnp.asarray(bd),
                             jnp.asarray(be), leaf_capacity=M, k=k,
                             interpret=True)
    dt, et = refine.refine_topk(
        torch.from_numpy(q), torch.from_numpy(qsq), st,
        torch.from_numpy(sqn), torch.from_numpy(ids),
        torch.from_numpy(alive), torch.from_numpy(bd), torch.from_numpy(be),
        leaf_capacity=M, k=k)
    return np.array(dj), np.array(ej), dt.numpy(), et.numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("Q,K,M,NL,L,k,alive_mode", [
    (4, 3, 8, 11, 64, 5, "random"),
    (5, 4, 16, 9, 128, 10, "all_dead_row"),
    (1, 8, 32, 40, 256, 10, "random"),
    (3, 2, 4, 6, 64, 12, "random"),       # k > the round's candidates
])
def test_refine_matches_pallas_over_a_carried_buffer(Q, K, M, NL, L, k,
                                                     alive_mode, dtype):
    series, sqn, q, qsq, ids, alive = _refine_inputs(
        Q, K, M, NL, L, k, alive_mode, seed=Q * 7 + k)
    bd = np.full((Q, k), 1e30, np.float32)
    be = np.zeros((Q, k), np.int32)
    tol = 1e-5 * (qsq.max() + sqn[sqn < 1e30].max())
    for rnd in range(2):                  # round 2 folds into a real carry
        ids = np.roll(ids, rnd, axis=1)
        dj, ej, dt, et = _run_both(series, sqn, q, qsq, ids, alive, bd, be,
                                   M, k, dtype)
        np.testing.assert_array_equal(et, ej)
        np.testing.assert_allclose(dt, dj, rtol=0, atol=tol)
        bd, be = dj, ej
    if alive_mode == "all_dead_row":
        assert (dt[0] == 1e30).all() and (et[0] == 0).all()


def test_refine_plain_breaks_ties_to_the_lower_union_index():
    """Equal distances: buffer slots first, then candidates in slot order
    (what jax.lax.top_k gives the JAX oracle)."""
    L, M = 8, 2
    series = torch.zeros(4 * M, L)
    sqn = torch.zeros(4 * M)
    q = torch.zeros(1, L)
    d, e = ref.refine_topk_ref(
        q, torch.zeros(1), series, sqn, torch.tensor([[3, 1]]),
        torch.tensor([[True, True]]), torch.tensor([[0.0, 1e30]]),
        torch.tensor([[5, 0]], dtype=torch.int32), leaf_capacity=M, k=4)
    assert e.tolist() == [[5, 6, 7, 2]]
    assert d.tolist() == [[0.0, 0.0, 0.0, 0.0]]


# ------------------------------------------------------------------ build
@pytest.mark.parametrize("name", ["ed_argmin", "flash_attention", "refine"])
def test_a_changed_header_changes_the_library_key(name, tmp_path,
                                                  monkeypatch):
    """The library of a source is keyed by the headers it includes too:
    editing csrc/sm90.cuh renames the libraries of the kernels that
    include it (the tensor-core kernels and refine's bulk-copy loop), so
    the next use rebuilds them, and leaves the others' names alone."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert _build.headers(csrc / f"{name}.cu") == [csrc / "sm90.cuh"]
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    with open(csrc / "sm90.cuh", "a") as f:
        f.write("// an edit\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    assert after[name] != before[name]
    assert after[name].name.startswith(name + "-")
    for other in ("isax_summarize", "lb_distance"):
        assert _build.headers(csrc / f"{other}.cu") == []
        assert after[other] == before[other]
