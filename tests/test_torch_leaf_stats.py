"""The build's per-leaf passes: the port's leaf_stats and leaf_gather
wrappers (repro_torch.kernels.leaf_stats / leaf_gather) against
repro.core.index.leaf_stats_blocks and plain gathers on the same numpy
inputs, and the index builder that calls them once a part.

min, max, a table lookup and a copy are exact, so every comparison here
is bit for bit: a partial last leaf, a leaf of padding only, leaves in
ranges written in place, and an IndexBuilder whose parts do not line up
with the leaves all give what the one-pass build gives.  On a device
that is neither the CPU nor CUDA the wrappers raise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import index as jindex
from repro.core import isax as jisax
from repro_torch.api import FreshIndex, IndexConfig
from repro_torch.core import index as tindex
from repro_torch.data.synthetic import random_walk
from repro_torch.kernels import leaf_gather as lg
from repro_torch.kernels import leaf_stats as ls

torch.set_num_threads(2)

N, W, M = 150, 16, 16               # 150 % 16: the last leaf holds 6 rows


def _inputs(bits, seed=0):
    """Source-ordered PAA and words of N rows, and a sort order."""
    rng = np.random.default_rng(seed + bits)
    paa = rng.standard_normal((N, W)).astype(np.float32)
    # rows that share a prefix, as sorted leaves do, so that prefix depths
    # other than 0 occur
    paa[: N // 2] = paa[0] + 0.05 * paa[: N // 2]
    words = np.asarray(jisax.sax_word(jnp.asarray(paa), bits)).astype(
        np.uint8)
    order = rng.permutation(N).astype(np.int64)
    return paa, words, order


def _repro_stats(paa, words, order, g, bits, bound):
    """repro's leaf_stats_blocks over g leaves of the sorted rows, the
    rows past N padded as repro's build pads them."""
    pw = np.full((g * M, W), np.inf, np.float32)
    ww = np.full((g * M, W), (1 << bits) - 1, np.uint8)
    vm = np.zeros((g * M,), bool)
    pw[:N], ww[:N], vm[:N] = paa[order], words[order], True
    lo, hi, lv = jindex.leaf_stats_blocks(
        jnp.asarray(pw.reshape(g, M, W)), jnp.asarray(ww.reshape(g, M, W)),
        jnp.asarray(vm.reshape(g, M, 1)), bits=bits, bound=bound)
    return np.asarray(lo), np.asarray(hi), np.asarray(lv)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("bound", ["prefix", "symbox", "paabox"])
def test_leaf_stats_equals_repro_and_the_plain_blocks(bound, bits):
    paa, words, order = _inputs(bits)
    t = [torch.from_numpy(a) for a in (paa, words, order)]
    g = -(-N // M) + 1                  # one more leaf: padding only
    out = (torch.zeros(g, W), torch.zeros(g, W),
           torch.zeros(g, dtype=torch.bool))
    ls.launcher(*t, N, leaf_capacity=M, bits=bits, bound=bound,
                out=out)(0, g)
    got = out
    want = _repro_stats(paa, words, order, g, bits, bound)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
    assert got[2].tolist() == [True] * (g - 1) + [False]
    assert torch.isinf(got[0][-1]).all() and torch.isinf(got[1][-1]).all()
    # the port's leaf_stats_blocks on the rows gathered through the order
    pw = torch.full((g * M, W), float("inf"))
    ww = torch.full((g * M, W), (1 << bits) - 1, dtype=torch.uint8)
    vm = torch.zeros(g * M, dtype=torch.bool)
    pw[:N], ww[:N], vm[:N] = t[0][t[2]], t[1][t[2]], True
    blocks = tindex.leaf_stats_blocks(pw.reshape(g, M, W),
                                      ww.reshape(g, M, W),
                                      vm.reshape(g, M, 1), bits=bits,
                                      bound=bound)
    for a, b in zip(got, blocks):
        assert torch.equal(a, b)
    # leaf_stats: the ceil(N / M) leaves the rows fill, in one launch
    whole = ls.leaf_stats(*t, N, leaf_capacity=M, bits=bits, bound=bound)
    for a, b in zip(whole, got):
        assert torch.equal(a, b[:g - 1])


@pytest.mark.parametrize("bound", ["prefix", "paabox"])
def test_leaf_stats_in_ranges_writes_only_its_leaves(bound):
    paa, words, order = _inputs(8, seed=1)
    t = [torch.from_numpy(a) for a in (paa, words, order)]
    whole = ls.leaf_stats(*t, N, leaf_capacity=M, bits=8, bound=bound)
    g = whole[0].shape[0]
    out = (torch.full((g, W), 7.0), torch.full((g, W), 7.0),
           torch.zeros(g, dtype=torch.bool))
    launch = ls.launcher(*t, N, leaf_capacity=M, bits=8, bound=bound,
                         out=out)
    for l0, l1 in ((0, 3), (3, 4), (4, 4), (4, g)):
        launch(l0, l1)
        assert (out[0][l1:] == 7.0).all()
    for a, b in zip(out, whole):
        assert torch.equal(a, b)


def test_leaf_stats_refuses_what_the_kernel_does_not_take():
    paa, words, order = (torch.from_numpy(a) for a in _inputs(8))
    kw = dict(leaf_capacity=M, bits=8, bound="prefix")
    for args, err in (((paa.double(), words, order, N), TypeError),
                      ((paa, words.int(), order, N), TypeError),
                      ((paa, words, order.int(), N), TypeError),
                      ((paa, words[:, :8], order, N), ValueError),
                      ((paa.t(), words.t(), order, N), ValueError),
                      ((paa, words, order, N + 1), ValueError)):
        with pytest.raises(err):
            ls.leaf_stats(*args, **kw)
    with pytest.raises(ValueError):
        ls.leaf_stats(paa, words, order, N, **{**kw, "bound": "box"})
    with pytest.raises(ValueError, match="out must be"):
        ls.launcher(paa, words, order, N, **kw,
                    out=(torch.zeros(10, W), torch.zeros(10, W),
                         torch.zeros(10, dtype=torch.int32)))
    small = (torch.zeros(2, W), torch.zeros(2, W),
             torch.zeros(2, dtype=torch.bool))
    launch = ls.launcher(paa, words, order, N, **kw, out=small)
    launch(0, 2)
    for l0, l1 in ((1, 3), (2, 1), (-1, 1)):
        with pytest.raises(ValueError, match="l1 <= 2"):
            launch(l0, l1)


def test_the_wrappers_raise_on_a_device_that_is_neither_cpu_nor_cuda():
    meta = dict(device="meta")
    paa = torch.empty(N, W, **meta)
    words = torch.empty(N, W, dtype=torch.uint8, **meta)
    order = torch.empty(N, dtype=torch.int64, **meta)
    before = (ls.launches, lg.launches)
    with pytest.raises(RuntimeError, match="no leaf_stats kernel"):
        ls.leaf_stats(paa, words, order, N, leaf_capacity=M, bits=8,
                      bound="prefix")
    src = (torch.empty(N, 32, **meta), paa, words, torch.empty(N, **meta))
    out = (torch.empty(N, 32, **meta), torch.empty(N, W, **meta),
           torch.empty(N, W, dtype=torch.uint8, **meta),
           torch.empty(N, **meta), torch.empty(N, dtype=torch.int32, **meta))
    with pytest.raises(RuntimeError, match="no leaf_gather kernel"):
        lg.launcher(order, src, out)
    assert (ls.launches, lg.launches) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_perm", [False, True])
def test_leaf_gather_equals_the_torch_gathers(dtype, with_perm):
    paa, words, order = (torch.from_numpy(a) for a in _inputs(8, seed=2))
    series = torch.from_numpy(random_walk(N, 50, seed=3)).to(dtype)
    sqn = (series.float() ** 2).sum(1)
    perm = (torch.randperm(N, generator=torch.Generator().manual_seed(4))
            .to(torch.int32) if with_perm else None)
    P = -(-N // M) * M
    out = (torch.zeros(P, 50, dtype=dtype), torch.full((P, W), 9.0),
           torch.zeros(P, W, dtype=torch.uint8), torch.zeros(P),
           torch.full((P,), -1, dtype=torch.int32))
    launch = lg.launcher(order, (series, paa, words, sqn), out, perm)
    for r0, r1 in ((0, 64), (64, 100), (100, 100), (100, N)):
        launch(r0, r1)
    with pytest.raises(ValueError, match=f"r1 <= {N}"):
        launch(100, N + 1)
    assert torch.equal(out[0][:N], series[order])
    assert torch.equal(out[1][:N], paa[order])
    assert torch.equal(out[2][:N], words[order])
    assert torch.equal(out[3][:N], sqn[order])
    ids = order.to(torch.int32) if perm is None else perm[order]
    assert torch.equal(out[4][:N], ids)
    # the padding rows past N are left as they were
    assert (out[1][N:] == 9.0).all() and (out[4][N:] == -1).all()


def test_leaf_gather_copy_width_follows_the_row_and_the_bases():
    assert lg.route(1024, 0, 4096) == "u16"
    assert lg.route(400, 16, 32) == "u16"       # L 100 float32
    assert lg.route(200, 0, 16) == "u8"         # L 100 bfloat16
    assert lg.route(200, 8, 16) == "u8"
    assert lg.route(1024, 4, 0) == "u4"         # a base off 16 bytes
    assert lg.route(50, 0, 16) == "u2"          # L 25 bfloat16
    with pytest.raises(ValueError):
        lg.launcher(torch.zeros(4, dtype=torch.int64),
                    (torch.zeros(4, 8), torch.zeros(4, 2),
                     torch.zeros(4, 2, dtype=torch.uint8), torch.zeros(4)),
                    (torch.zeros(4, 8), torch.zeros(4, 2),
                     torch.zeros(4, 2, dtype=torch.uint8), torch.zeros(4),
                     torch.zeros(4)))                      # perm not int32


@pytest.fixture(scope="module")
def walks():
    return random_walk(1000, 256, seed=11)      # 1000 % 32: padded leaf


@pytest.mark.parametrize("bound", ["prefix", "symbox", "paabox"])
def test_builder_with_parts_off_the_leaves_is_bit_equal(walks, bound,
                                                        monkeypatch):
    """4 workers, part_rows 100 (not a multiple of the 32-row leaves):
    leaf_stats parts of 3 leaves and materialize parts of 100 rows, one
    wrapper call a part, and build_index's bits."""
    cfg = IndexConfig(leaf_capacity=32, bound=bound)
    ref = FreshIndex.build(walks, cfg, device="cpu")
    calls = {ls: 0, lg: 0}

    def counted(mod):
        make = mod.launcher

        def launcher(*a, **kw):
            launch = make(*a, **kw)

            def counted_launch(*r):
                calls[mod] += 1
                return launch(*r)
            return counted_launch
        return launcher
    for mod in calls:
        monkeypatch.setattr(mod, "launcher", counted(mod))
    b = FreshIndex.builder(cfg, workers=4, part_rows=100, device="cpu")
    ix = b.feed(walks).finalize()
    for f in ix.index._fields:
        assert torch.equal(getattr(ix.index, f), getattr(ref.index, f)), f
    n_leaves = -(-1000 // 32)
    rep = b.report()["phases"]
    assert rep["leaf_stats"]["parts"] == -(-n_leaves // 3)
    assert rep["materialize"]["parts"] == -(-n_leaves * 32 // 100)
    # helpers may apply a part again, never skip one
    assert calls[ls] >= rep["leaf_stats"]["parts"]
    assert calls[ls] == rep["leaf_stats"]["applications"]
    assert calls[lg] >= 10                      # the 10 parts with rows
