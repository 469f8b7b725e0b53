"""The port's iSAX math (repro_torch.core.isax) against repro.core.isax on
the same numpy inputs: floats at rtol/atol 1e-5, words and keys equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import isax as jisax
from repro_torch.core import isax

torch.set_num_threads(2)


def _walks(n, L=256, seed=0):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.standard_normal((n, L)), axis=1).astype(np.float32)


def test_breakpoints_are_the_same_table():
    for bits in (2, 4, 8):
        np.testing.assert_array_equal(isax.breakpoints(bits),
                                      jisax.breakpoints(bits))
        np.testing.assert_array_equal(isax.padded_breakpoints(bits),
                                      jisax.padded_breakpoints(bits))


def test_znormalize_and_paa_match():
    x = _walks(64, seed=1)
    zt = isax.znormalize(torch.from_numpy(x))
    zj = jisax.znormalize(jnp.asarray(x))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-5,
                               atol=1e-5)
    for w in (8, 16):
        np.testing.assert_allclose(
            isax.paa(zt, w).numpy(), np.asarray(jisax.paa(zj, w)),
            rtol=1e-5, atol=1e-5)
    pt, wt = isax.summarize(zt)
    pj, wj = jisax.summarize(zj)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))


def test_paa_rejects_ragged_segments():
    with pytest.raises(ValueError):
        isax.paa(torch.zeros(2, 250), 16)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_words_and_keys_bit_exact(bits):
    x = _walks(300, seed=bits)
    p = np.array(jisax.paa(jisax.znormalize(jnp.asarray(x)), 16))
    wt = isax.sax_word(torch.from_numpy(p), bits)
    wj = np.array(jisax.sax_word(jnp.asarray(p), bits))
    assert wt.dtype == torch.uint8
    np.testing.assert_array_equal(wt.numpy(), wj)
    kt = isax.interleaved_key(wt, bits)
    kj = np.asarray(jisax.interleaved_key(jnp.asarray(wj), bits))
    assert kt.dtype == torch.int32 and kt.shape == kj.shape
    np.testing.assert_array_equal(kt.numpy(), kj)


def test_sax_word_counts_breakpoints_at_or_below():
    """side="right": a value equal to a breakpoint lands above it (0.0 is
    the middle breakpoint at 8 bits)."""
    v = torch.tensor([0.0, -1e-7, 1e-7])
    np.testing.assert_array_equal(isax.sax_word(v, 8).numpy(),
                                  np.asarray(jisax.sax_word(
                                      jnp.asarray(v.numpy()), 8)))
    assert isax.sax_word(v, 8).tolist() == [128, 127, 128]


@pytest.mark.parametrize("bits", [4, 8])
def test_symbol_region_matches_at_every_depth(bits):
    rng = np.random.default_rng(3)
    sym = rng.integers(0, 1 << bits, (50, 16)).astype(np.uint8)
    depth = rng.integers(0, bits + 1, (50, 16)).astype(np.int32)
    lt, ht = isax.symbol_region(torch.from_numpy(sym),
                                torch.from_numpy(depth), bits)
    lj, hj = jisax.symbol_region(jnp.asarray(sym), jnp.asarray(depth), bits)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    lt, ht = isax.symbol_region(torch.from_numpy(sym), bits, bits)
    lj, hj = jisax.symbol_region(jnp.asarray(sym), bits, bits)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))


def test_mindist_region_matches_with_infinite_edges():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((6, 16)).astype(np.float32)
    lo = (rng.standard_normal((6, 16)) - 0.5).astype(np.float32)
    hi = lo + np.abs(rng.standard_normal((6, 16))).astype(np.float32)
    lo[0, :3] = -np.inf
    hi[1, :3] = np.inf
    lo[2], hi[2] = np.inf, np.inf
    dt = isax.mindist_region_sq(torch.from_numpy(q), torch.from_numpy(lo),
                                torch.from_numpy(hi))
    dj = jisax.mindist_region_sq(jnp.asarray(q), jnp.asarray(lo),
                                 jnp.asarray(hi))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-5)
    assert np.isinf(dt[2].item())
