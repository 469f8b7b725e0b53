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


# ----------------------------------------------- the kernel's arithmetic
def _tf32(x):
    """Round float32 to the nearest tf32 (10 mantissa bits, ties away from
    zero), as the kernel's cvt.rna.tf32.f32: add half of the 13 dropped
    bits to the magnitude, then clear them."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1fff).view(torch.float32)


def _ed_argmin_tf32(q, xs, products=3):
    """(d, i) as the kernel computes them: q.x from tf32 halves, summed in
    float32, with q_hi.x_hi (products=1), or with q_hi.x_lo and q_lo.x_hi
    too (products=3).  Each (query, candidate) pair goes through the same
    elementwise operations, as each does in the kernel."""
    q, x = torch.as_tensor(q).float(), torch.as_tensor(xs).float()
    qh, xh = _tf32(q), _tf32(x)
    pairs = [(qh, xh), (qh, _tf32(x - xh)), (_tf32(q - qh), xh)]
    dot = sum((a[:, None, :] * b[None]).sum(-1) for a, b in pairs[:products])
    d2 = ((q * q).sum(-1)[:, None] + (x * x).sum(-1)[None]
          - 2.0 * dot).clamp_min(0.0)
    i = torch.argmin(d2, dim=1)
    return d2.gather(1, i[:, None])[:, 0].numpy(), i.int().numpy()


def test_tf32_rounding_keeps_ten_mantissa_bits_to_nearest():
    x = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -11, 1 + 2 ** -12,
                      -(1 + 3 * 2 ** -12), 3.1415927], dtype=torch.float32)
    want = [1.0, 1 + 2 ** -10, 1 + 2 ** -10, 1.0, -(1 + 2 ** -10),
            3.140625]
    assert _tf32(x).tolist() == want


@pytest.mark.parametrize("Q,N,L", [(1, 64, 256), (16, 1000, 256),
                                   (5, 33, 128), (32, 4096, 64)])
def test_3xtf32_matches_pallas_where_one_tf32_product_does_not(Q, N, L):
    """repro's shapes: three tf32 products hold repro's rtol/atol 1e-4 with
    the same ids; one product alone (three decimal digits of q.x) misses
    that tolerance on three of the four."""
    q, xs = _walks(Q, L, seed=2), _walks(N, L, seed=9)
    dj, ij = jops.ed_argmin(jnp.asarray(q), jnp.asarray(xs), interpret=True)
    dj, ij = np.asarray(dj), np.asarray(ij)
    _agree(dj, ij, *_ed_argmin_tf32(q, xs))
    d1, _ = _ed_argmin_tf32(q, xs, products=1)
    beyond = np.abs(d1 - dj) > 1e-4 + 1e-4 * np.abs(dj)
    assert beyond.any() == ((Q, N, L) != (1, 64, 256))


def test_3xtf32_bf16_candidates_need_two_products():
    """A bf16 value is exact in tf32 (x_lo = 0): the kernel's bf16 route
    runs q_hi.x + q_lo.x alone and still holds repro's tolerance."""
    q = np.array(jisax.znormalize(jnp.asarray(_walks(16, 256, seed=4))))
    xb = np.array(jisax.znormalize(jnp.asarray(_walks(1000, 256, seed=5))))
    xb = xb.astype(ml_dtypes.bfloat16).astype(np.float32)
    xt = torch.from_numpy(xb)
    assert torch.equal(_tf32(xt), xt)
    dj, ij = jops.ed_argmin(jnp.asarray(q), jnp.asarray(xb), interpret=True)
    _agree(np.asarray(dj), np.asarray(ij), *_ed_argmin_tf32(q, xb))


def test_3xtf32_keeps_the_duplicated_row_tie():
    """Identical rows give bitwise-identical 3xTF32 d^2, so the tie goes to
    the lower index, as the card's check requires."""
    xs = np.array(jisax.znormalize(jnp.asarray(_walks(300, 256, seed=6))))
    xs[250] = xs[17]
    q = xs[[17, 250, 3]].copy()
    d, i = _ed_argmin_tf32(q, xs)
    np.testing.assert_array_equal(i, [17, 17, 3])
    dj, _ = jops.ed_argmin(jnp.asarray(q), jnp.asarray(xs), interpret=True)
    np.testing.assert_allclose(d, np.asarray(dj), rtol=1e-4, atol=1e-4)
