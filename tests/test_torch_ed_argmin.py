"""The port's exact 1-NN scan (ed_argmin) against repro's Pallas kernel
in interpret mode, on the same numpy inputs.

On the CPU the wrapper runs its plain version; the CUDA kernel is held
against the same plain version on the card by chip_smoke.py.  Tolerances
are repro's own (tests/test_kernels.py, ed_argmin): d^2 at rtol/atol
1e-4, the matmul form summing in another order; ids equal except at
near-ties, where the two d^2 must agree at rtol 1e-4.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import isax as jisax
from repro.kernels import ops as jops
from repro_torch.api import FreshIndex
from repro_torch.core import isax, search
from repro_torch.kernels import ops

torch.set_num_threads(2)


def _walks(n, L, seed=0):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.standard_normal((n, L)), 1).astype(np.float32)


def _both(q, xs, bf16=False):
    """(d, i) of repro (interpret mode) and of the port, as numpy."""
    if bf16:
        xb = xs.astype(ml_dtypes.bfloat16)
        xj = jnp.asarray(xb)
        xt = torch.from_numpy(xb.view(np.uint16)).view(torch.bfloat16)
    else:
        xj, xt = jnp.asarray(xs), torch.from_numpy(xs)
    dj, ij = jops.ed_argmin(jnp.asarray(q), xj, interpret=True)
    dt, it = ops.ed_argmin(torch.from_numpy(q), xt)
    assert dt.dtype == torch.float32 and it.dtype == torch.int32
    return np.asarray(dj), np.asarray(ij), dt.numpy(), it.numpy()


def _agree(dj, ij, dt, it):
    np.testing.assert_allclose(dt, dj, rtol=1e-4, atol=1e-4)
    ties = ij != it
    if ties.any():                  # argmin ties: the distances agree
        np.testing.assert_allclose(dt[ties], dj[ties], rtol=1e-4)


@pytest.mark.parametrize("Q,N,L", [(1, 64, 256), (16, 1000, 256),
                                   (5, 33, 128), (32, 4096, 64)])
def test_ed_argmin_matches_pallas(Q, N, L):
    _agree(*_both(_walks(Q, L, seed=2), _walks(N, L, seed=9)))


@pytest.mark.parametrize("Q,N,L", [(16, 1000, 256), (5, 33, 128)])
def test_ed_argmin_bf16_candidates_match_pallas(Q, N, L):
    q = jisax.znormalize(jnp.asarray(_walks(Q, L, seed=4)))
    xs = jisax.znormalize(jnp.asarray(_walks(N, L, seed=5)))
    _agree(*_both(np.array(q), np.array(xs), bf16=True))


@pytest.mark.parametrize("bf16", [False, True])
def test_a_duplicated_row_goes_to_the_lowest_index(bf16):
    xs = np.array(jisax.znormalize(jnp.asarray(_walks(300, 256, seed=6))))
    xs[250] = xs[17]
    if bf16:                   # the query is the stored (rounded) row
        xs = xs.astype(ml_dtypes.bfloat16).astype(np.float32)
    q = xs[[17, 250, 3]].copy()
    dj, ij, dt, it = _both(q, xs, bf16=bf16)
    np.testing.assert_array_equal(ij, [17, 17, 3])
    np.testing.assert_array_equal(it, [17, 17, 3])
    np.testing.assert_allclose(dt, dj, rtol=1e-4, atol=1e-4)


def test_one_nn_composes_with_the_index(walks):
    """summarize -> ed_argmin over the z-normalized collection is exact
    1-NN: the same ids as the port's search(k=1) and brute force, and as
    repro's kernel.  d^2 is held to the direct-form distance squared at
    rtol/atol 1e-4: near 0 the matmul form cancels |q|^2 + |x|^2 = 512
    and keeps an error of some 1e-5 in d^2, so its square root may be
    off by 1e-2 where the true distance is 0."""
    x = torch.from_numpy(np.asarray(walks[:512], np.float32))
    rng = np.random.default_rng(12)
    rows = [5, 77, 300, 511]
    noisy = walks[rows] + 0.3 * rng.standard_normal((4, 256))
    queries = torch.from_numpy(np.concatenate(
        [walks[rows] + 0.01, noisy]).astype(np.float32))
    paa, words = ops.summarize(x)
    assert paa.shape == (512, 16) and words.dtype == torch.int32
    d, i = ops.ed_argmin(isax.znormalize(queries), isax.znormalize(x))
    db, ib = search.search_bruteforce(x, queries)
    ds, is_ = FreshIndex.build(x, device="cpu").search(queries, k=1)
    np.testing.assert_array_equal(i.numpy(), ib.numpy())
    np.testing.assert_array_equal(i.numpy(), is_.numpy())
    np.testing.assert_array_equal(i[:4].numpy(), rows)
    np.testing.assert_allclose(d.numpy(), db.square().numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(ds.numpy(), db.numpy(), rtol=1e-5, atol=1e-5)
    dj, ij = jops.ed_argmin(jisax.znormalize(jnp.asarray(queries.numpy())),
                            jisax.znormalize(jnp.asarray(x.numpy())),
                            interpret=True)
    np.testing.assert_array_equal(np.asarray(ij), i.numpy())
    np.testing.assert_allclose(np.asarray(dj), d.numpy(), rtol=1e-4,
                               atol=1e-4)
