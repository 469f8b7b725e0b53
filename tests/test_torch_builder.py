"""The port's IndexBuilder (repro_torch.core.builder) against its own
one-pass build and against repro's IndexBuilder, on the same walks.

The load-bearing property is schedule-independence: a multi-worker build
under crash and delay injectors, a chunked feed and the sequential build
give arrays BIT-IDENTICAL to `build_index`.  Against repro's builder:
words, perm, valid and leaf_valid equal; series, paa, sq_norms and the
leaf regions within rtol/atol 1e-5 with infinities in the same places.
Compaction (`merge_sorted_delta`) keeps the stored core bits, and
compact∘compact == compact.
"""

import numpy as np
import pytest
import torch

from repro.core import isax as jisax
from repro.core.builder import IndexBuilder as JIndexBuilder
from repro.api import IndexConfig as JIndexConfig
from repro_torch.api import FreshIndex, IndexConfig
from repro_torch.core import index as tindex
from repro_torch.core import isax
from repro_torch.core.builder import IndexBuilder, merge_sorted_delta
from repro_torch.core.refresh import Injectors
from repro_torch.core.search import search_bruteforce
from repro_torch.data.synthetic import query_workload, random_walk
from repro_torch.kernels import isax_summarize as ks

torch.set_num_threads(2)

CFG = IndexConfig(leaf_capacity=32)
EXACT = ("perm", "words", "valid", "leaf_valid")
CLOSE = ("series", "paa", "sq_norms", "leaf_lo", "leaf_hi")


def assert_bit_identical(a, b, context=""):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, (context, f)
        assert torch.equal(x, y), f"{context}: {f}"


@pytest.fixture(scope="module")
def small():
    return random_walk(1000, 256, seed=7)        # 1000 % 32: padded leaf


@pytest.fixture(scope="module")
def reference(small):
    return FreshIndex.build(small, CFG, device="cpu")


# --------------------------------------------------------------------- #
# the host-side key machinery
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("bits,segments", [(8, 16), (4, 8), (3, 5)])
def test_host_keys_match_the_device_key_and_repro(bits, segments):
    rng = np.random.default_rng(3)
    words = rng.integers(0, 1 << bits, size=(257, segments), dtype=np.uint8)
    kn = isax.interleaved_key_np(words, bits)
    np.testing.assert_array_equal(kn, jisax.interleaved_key_np(words, bits))
    np.testing.assert_array_equal(
        kn, isax.interleaved_key(torch.from_numpy(words), bits).numpy())
    np.testing.assert_array_equal(isax.lexsort_keys(kn),
                                  jisax.lexsort_keys(kn))
    np.testing.assert_array_equal(
        isax.lexsort_keys(kn),
        tindex.lexsort_lanes(torch.from_numpy(kn)).numpy())
    packed = isax.pack_keys_bytes(kn)
    np.testing.assert_array_equal(packed, jisax.pack_keys_bytes(kn))
    np.testing.assert_array_equal(np.argsort(packed, kind="stable"),
                                  isax.lexsort_keys(kn))
    np.testing.assert_array_equal(
        isax.root_bucket(torch.from_numpy(words), bits).numpy(),
        np.asarray(jisax.root_bucket(words, bits)))


def test_summarize_rows_does_not_depend_on_the_rows_beside_it(small):
    """The summarize phase runs part by part, build_index over all rows:
    a row's series, paa, words and norm are the same bits either way."""
    x = torch.from_numpy(small)
    whole = tindex.summarize_rows(x, segments=16, bits=8, znorm=True)
    for lo, hi in ((0, 128), (128, 133), (999, 1000)):
        part = tindex.summarize_rows(x[lo:hi], segments=16, bits=8,
                                     znorm=True)
        for a, b in zip(part, whole):
            assert torch.equal(a, b[lo:hi])


def test_summarize_rows_writes_in_place_into_slices(small):
    """With out=, the wrapper writes each of its four outputs into the
    given slices and leaves the rows around them alone."""
    x = torch.from_numpy(small[:40])
    fresh = ks.summarize_rows(x[10:30], segments=16)
    shapes = ((40, 256), (40, 16), (40, 16), (40,))
    dtypes = (torch.float32, torch.float32, torch.int32, torch.float32)
    buf = tuple(torch.zeros(s, dtype=t) for s, t in zip(shapes, dtypes))
    got = ks.summarize_rows(x[10:30], segments=16,
                            out=tuple(b[10:30] for b in buf))
    for g, f, b in zip(got, fresh, buf):
        assert torch.equal(g, f) and torch.equal(b[10:30], f)
        assert not b[:10].any() and not b[30:].any()


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided", "count"])
def test_summarize_rows_refuses_a_wrong_out(small, bad):
    x = torch.from_numpy(small[:8])
    out = [torch.empty(8, 256), torch.empty(8, 16),
           torch.empty(8, 16, dtype=torch.int32), torch.empty(8)]
    if bad == "dtype":
        out[2] = torch.empty(8, 16, dtype=torch.uint8)
    elif bad == "shape":
        out[1] = torch.empty(8, 8)
    elif bad == "strided":
        out[0] = torch.empty(8, 512)[:, ::2]
    else:
        out = out[:3]
    with pytest.raises(ValueError, match="out must be"):
        ks.summarize_rows(x, segments=16, out=tuple(out))


# --------------------------------------------------------------------- #
# every schedule gives the one-pass build's bits
# --------------------------------------------------------------------- #
def _crash_some():
    return Injectors.crashing({1, 2, 3}, after=1)


def _crash_all():
    return Injectors.crashing({0, 1, 2, 3}, after=0)


def _delay():
    return Injectors.delaying(0.002, worker_ids={0}, every=2)


@pytest.mark.parametrize("workers,part_rows,injectors,chunk", [
    (0, 2048, None, None),                 # one part, sequential
    (1, 128, None, 192),                   # chunked, ragged feeds
    (4, 128, None, None),
    (4, 128, _crash_some, None),           # 3 of 4 workers crash
    (4, 256, _crash_all, None),            # all crash: the caller helps
    (4, 128, _delay, 300),
])
def test_builder_is_bit_identical_to_build_index(small, reference, workers,
                                                 part_rows, injectors,
                                                 chunk):
    b = FreshIndex.builder(CFG, workers=workers, part_rows=part_rows,
                           injectors=injectors() if injectors else None,
                           device="cpu")
    step = chunk or small.shape[0]
    for lo in range(0, small.shape[0], step):
        b.feed(small[lo:lo + step])
    ix = b.finalize()
    assert_bit_identical(ix.index, reference.index, "builder")
    rep = b.report()
    apps = sum(p["applications"] for p in rep["phases"].values())
    parts = sum(p["parts"] for p in rep["phases"].values())
    if workers >= 2 and injectors is not _crash_all:
        assert apps >= parts               # helping may repeat, never skip
    if injectors is _crash_some:
        assert sum(p["crashed_workers"]
                   for p in rep["phases"].values()) >= 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_builder_matches_repro_builder(small, dtype):
    ti = IndexBuilder(IndexConfig(leaf_capacity=32, dtype=dtype), workers=4,
                      part_rows=256, device="cpu").feed(small).finalize()
    ji = JIndexBuilder(JIndexConfig(leaf_capacity=32, dtype=dtype),
                       workers=4, part_rows=256).feed(small).finalize()
    for f in EXACT:
        a, b = getattr(ti.index, f).numpy(), np.asarray(getattr(ji.index, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in CLOSE:
        a = getattr(ti.index, f).float().numpy()
        b = np.asarray(getattr(ji.index, f), np.float32)
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b), err_msg=f)
        fin = np.isfinite(b)
        # bf16 storage rounds float32 values that agree to 1e-5; where they
        # straddle a rounding boundary the stored values are one bf16 step
        # (2^-7 of the value) apart
        rtol = 2 ** -7 if f == "series" and dtype == "bfloat16" else 1e-5
        np.testing.assert_allclose(a[fin], b[fin], rtol=rtol, atol=1e-5,
                                   err_msg=f)


def test_feed_is_eager_for_complete_blocks(small):
    b = IndexBuilder(CFG, part_rows=256, device="cpu")
    b.feed(small[:600])
    rep = b.report()
    assert rep["phases"]["summarize"]["parts"] == 2      # 600 // 256
    assert rep["phases"]["sort"]["parts"] == 2
    assert rep["phases"]["merge"]["parts"] == 0          # finalize-only
    b.feed(small[600:]).finalize()
    assert b.report()["phases"]["merge"]["parts"] > 0


def test_feed_copies_a_reused_caller_buffer(small, reference):
    b = IndexBuilder(CFG, part_rows=256, device="cpu")
    buf = torch.empty((100, 256))
    for lo in range(0, small.shape[0], 100):
        chunk = torch.from_numpy(small[lo:lo + 100])
        buf[:chunk.shape[0]] = chunk
        b.feed(buf[:chunk.shape[0]])
        buf[:] = float("nan")                    # the caller reuses it
    assert_bit_identical(b.finalize().index, reference.index, "reused")


def test_builder_validation():
    b = IndexBuilder(CFG, device="cpu")
    with pytest.raises(ValueError, match="no data fed"):
        b.finalize()
    with pytest.raises(ValueError, match="not divisible"):
        b.feed(np.zeros((4, 250), np.float32))
    b.feed(np.zeros((4, 256), np.float32))
    with pytest.raises(ValueError, match="series length"):
        b.feed(np.zeros((4, 128), np.float32))
    b.finalize()
    with pytest.raises(RuntimeError, match="finalize"):
        b.feed(np.zeros((4, 256), np.float32))
    with pytest.raises(RuntimeError, match="finalize"):
        b.finalize()
    with pytest.raises(ValueError, match="part_rows"):
        IndexBuilder(CFG, part_rows=0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            IndexBuilder(CFG)


# --------------------------------------------------------------------- #
# incremental compaction
# --------------------------------------------------------------------- #
def _rows_by_id(flat):
    """Index arrays keyed by series id."""
    v = flat.perm >= 0
    order = torch.argsort(flat.perm[v])
    return tuple(getattr(flat, f)[v][order]
                 for f in ("series", "paa", "words", "sq_norms"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_compact_preserves_stored_core_bits(small, dtype):
    cfg = IndexConfig(leaf_capacity=32, dtype=dtype)
    ix = FreshIndex.build(small[:512], cfg, device="cpu")
    before = _rows_by_id(ix.index)
    ix.add(random_walk(40, 256, seed=31)).compact()
    for b, a in zip(before, _rows_by_id(ix.index)):
        assert torch.equal(b, a[:512])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_compact_compact_equals_compact(small, dtype):
    cfg = IndexConfig(leaf_capacity=32, dtype=dtype)
    b1 = random_walk(40, 256, seed=32)
    b2 = random_walk(56, 256, seed=33)
    two = FreshIndex.build(small[:512], cfg, device="cpu")
    two.add(b1).compact()
    two.add(b2).compact()
    one = FreshIndex.build(small[:512], cfg, device="cpu")
    one.add(b1).add(b2).compact()
    assert_bit_identical(two.index, one.index, f"{dtype} split compacts")
    before = two.index
    assert two.compact() is two and two.index is before   # nothing to do


def test_compact_matches_a_fresh_build_f32(small):
    extra = random_walk(64, 256, seed=34)
    ix = FreshIndex.build(small[:512], CFG, device="cpu")
    ix.add(extra).compact()
    fresh = FreshIndex.build(np.concatenate([small[:512], extra]), CFG,
                             device="cpu")
    assert_bit_identical(ix.index, fresh.index, "merge vs fresh")


def test_empty_build_then_add_then_compact(small):
    data = small[:256]
    ix = FreshIndex.build(np.empty((0, 256), np.float32), CFG, device="cpu")
    assert ix.n_series == 0 and ix.index.n_leaves == 0
    ix.add(data)
    q = query_workload(data, 4, noise_sigma=0.05, seed=3)
    _, i_delta = ix.search(q, k=5)
    ix.compact()
    assert_bit_identical(ix.index, FreshIndex.build(
        data, CFG, device="cpu").index, "bootstrap")
    _, i = ix.search(q, k=5)
    _, ib = search_bruteforce(torch.from_numpy(data), torch.from_numpy(q),
                              k=5)
    assert torch.equal(i, ib) and torch.equal(i_delta, ib)


def test_merge_sorted_delta_direct_and_empty(small):
    ix = FreshIndex.build(small[:256], CFG, device="cpu")
    assert merge_sorted_delta(ix.index, np.zeros((0, 256), np.float32),
                              CFG) is ix.index
    with pytest.raises(ValueError, match="delta must be"):
        merge_sorted_delta(ix.index, np.zeros((4,), np.float32), CFG)
