"""The port's flat-index build (repro_torch.core.index) against
repro.core.index.build_index(backend="pallas") on the same random walks:
perm, words, valid and leaf_valid equal; series, paa, sq_norms and the
leaf regions allclose at 1e-5 with infinities in the same places."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.index import build_index as jbuild_index
from repro_torch.core import index as tindex
from repro_torch.data.synthetic import random_walk

torch.set_num_threads(2)

EXACT = ("perm", "words", "valid", "leaf_valid")
CLOSE = ("series", "paa", "sq_norms", "leaf_lo", "leaf_hi")


@pytest.fixture(scope="module", params=[2048, 2000])
def walks(request):
    # 2000 % 64 != 0: the last leaf is partly padding
    return random_walk(request.param, 256, seed=7)


@pytest.mark.parametrize("bound", ["prefix", "symbox", "paabox"])
def test_build_matches_pallas_build(walks, bound):
    ti = tindex.build_index(torch.from_numpy(walks), bound=bound)
    ji = jbuild_index(jnp.asarray(walks), bound=bound, backend="pallas")
    assert ti.n_leaves == ji.n_leaves and ti.leaf_capacity == 64
    for f in EXACT:
        a, b = getattr(ti, f).numpy(), np.asarray(getattr(ji, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in CLOSE:
        a, b = getattr(ti, f).numpy(), np.asarray(getattr(ji, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b), err_msg=f)
        fin = np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-5, atol=1e-5,
                                   err_msg=f)


def test_lexsort_lanes_is_numpy_lexsort():
    rng = np.random.default_rng(0)
    lanes = rng.integers(0, 4, (500, 5)).astype(np.int32)   # many ties
    lanes[:, 0] = rng.integers(0, 2**31 - 1, 500) % 3
    perm = tindex.lexsort_lanes(torch.from_numpy(lanes))
    want = np.lexsort(tuple(lanes[:, i] for i in range(4, -1, -1)))
    np.testing.assert_array_equal(perm.numpy(), want)


def test_bit_length_u8():
    x = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    want = [int(v).bit_length() for v in range(256)]
    assert tindex._bit_length_u8(x).tolist() == want


def test_fully_padded_leaf_has_an_empty_region():
    pw = torch.zeros(2, 4, 16)
    ww = torch.zeros(2, 4, 16, dtype=torch.uint8)
    vmask = torch.tensor([True, True, False, False]).repeat(2, 1)[..., None]
    vmask[1] = False
    lo, hi, lv = tindex.leaf_stats_blocks(pw, ww, vmask, bits=8,
                                          bound="prefix")
    assert lv.tolist() == [True, False]
    assert torch.isinf(lo[1]).all() and torch.isinf(hi[1]).all()
    assert torch.isfinite(hi[0]).all()
