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
from repro_torch.kernels import ed_argmin, ops

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


# ------------------------------------------- every row length, either loader
@pytest.mark.parametrize("L", [7, 100, 235])
@pytest.mark.parametrize("bf16", [False, True])
def test_every_row_length_matches_pallas_with_a_duplicated_row(L, bf16):
    """The card's route rows (L 100 float32 by TMA; bfloat16 L 100 and L
    235 by the staged loader) and L 7: repro's kernel in interpret mode
    and the port, at repro's tolerance, and row 600, a copy of row 41,
    loses the tie to it."""
    xs = np.array(jisax.znormalize(jnp.asarray(_walks(700, L, seed=L))))
    xs[600] = xs[41]
    if bf16:                   # the query is the stored (rounded) row
        xs = xs.astype(ml_dtypes.bfloat16).astype(np.float32)
    q = np.concatenate([xs[[41]], np.array(jisax.znormalize(
        jnp.asarray(_walks(20, L, seed=L + 1))))])
    dj, ij, dt, it = _both(q, xs, bf16=bf16)
    _agree(dj, ij, dt, it)
    assert ij[0] == it[0] == 41


@pytest.mark.parametrize("L", [7, 100, 235])
def test_3xtf32_holds_pallas_at_every_row_length(L):
    """The kernel's arithmetic at lengths that are not whole chunks of 32
    columns: the chunks' columns past L are zeros, which add nothing to
    the tf32 products (here to float32 rounding: torch sums the longer
    rows in another order; the kernel adds the zero products last), so
    3xTF32 over the L real columns holds repro's tolerance with the same
    ids, for float32 and bfloat16 rows."""
    q = np.array(jisax.znormalize(jnp.asarray(_walks(16, L, seed=3))))
    xs = np.array(jisax.znormalize(jnp.asarray(_walks(1000, L, seed=8))))
    pad = -L % ed_argmin.CHUNK
    for x in (xs, xs.astype(ml_dtypes.bfloat16).astype(np.float32)):
        dj, ij = jops.ed_argmin(jnp.asarray(q), jnp.asarray(x),
                                interpret=True)
        got = _ed_argmin_tf32(q, x)
        padded = _ed_argmin_tf32(np.pad(q, ((0, 0), (0, pad))),
                                 np.pad(x, ((0, 0), (0, pad))))
        np.testing.assert_allclose(got[0], padded[0], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got[1], padded[1])
        _agree(np.asarray(dj), np.asarray(ij), *got)


# ----------------------------------------- the staged loader's address map
KBM = 128                       # rows of a candidate tile (csrc kBM)


def _tma_byte(row, col, elem):
    """Where TMA puts value (row, col) of a (KBM x CHUNK) box of elem-byte
    values with the swizzle the kernel's map asks for: rows of span =
    CHUNK * elem bytes, 128 (SWIZZLE_128B: the row's 16-byte chunk j at
    j XOR row % 8) or 64 (SWIZZLE_64B: j XOR (row // 2) % 4)."""
    span = ed_argmin.CHUNK * elem
    j, b = divmod(col * elem, 16)
    j ^= row % 8 if span == 128 else row // 2 % 4
    return row * span + 16 * j + b


def _staged_chunk(elem, N, L, n0, c0):
    """csrc/ed_argmin.cu stage_chunk, thread by thread: every byte of the
    chunk it writes, as {byte: (row, col, byte of the value)} for a value
    it reads, or None for a zero (past N or L).  Thread pt's units are u =
    pt + 128 i, each 16 bytes (piece u % P of row u // P, P = span // 16)
    stored whole.  Asserts no byte is written twice."""
    span = ed_argmin.CHUNK * elem
    mask = 7 if span == 128 else 3
    per, vals = span // 16, 16 // elem
    wrote = {}
    for pt in range(128):
        for i in range(KBM * per // 128):
            u = pt + 128 * i
            row, col = u // per, u % per * vals
            off = row * span + u % per * 16
            at = off ^ (((off >> 7) & mask) << 4)
            for b in range(16):
                assert at + b not in wrote, "a byte written twice"
                c = col + b // elem
                wrote[at + b] = ((row, c, b % elem)
                                 if n0 + row < N and c0 + c < L else None)
    return wrote


@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("N,L,n0,c0", [(1000, 100, 0, 96),
                                       (1000, 235, 896, 224),
                                       (1000, 100, 128, 32),
                                       (5, 7, 0, 0)])
def test_staged_chunk_writes_each_value_where_tma_does(elem, N, L, n0, c0):
    """The staged loader (rows TMA cannot take) fills the ring's chunk
    byte for byte as TMA would: every value of the chunk's rows [n0, n0
    + 128) and columns [c0, c0 + 32) inside N and L on TMA's swizzled
    byte, zeros on every other byte of the chunk, no byte written twice,
    so the consumers (x_at) read the same values from either loader."""
    wrote = _staged_chunk(elem, N, L, n0, c0)
    want = {}
    for row in range(KBM):
        for col in range(ed_argmin.CHUNK):
            ok = n0 + row < N and c0 + col < L
            for b in range(elem):
                want[_tma_byte(row, col, elem) + b] = ((row, col, b) if ok
                                                       else None)
    assert len(want) == KBM * ed_argmin.CHUNK * elem
    assert wrote == want


def _load16_pieces(a, valid):
    """csrc/sm90.cuh load16's loads of the 16 bytes at an address a mod 16
    (even): [(offset, width)], the widest pieces a's alignment allows,
    each read only where it starts before `valid`."""
    if valid <= 0:
        return []
    w = 16 if a % 16 == 0 else 8 if a % 8 == 0 else 4 if a % 4 == 0 else 2
    return [(p, w) for p in range(0, 16, w) if p < valid]


def _copy16_pieces(a, valid):
    """csrc/sm90.cuh copy16 at an address a mod 16 (even): [(offset,
    width, bytes read)]: cp.async pieces of the widest width a's
    alignment allows where a is 4-byte aligned, each reading the valid
    part of its piece (the rest zero-filled); None where it takes load16
    and a store instead."""
    if a % 4:
        return None
    w = 16 if a % 16 == 0 else 8 if a % 8 == 0 else 4
    return [(p, w, min(max(valid - p, 0), w)) for p in range(0, 16, w)]


@pytest.mark.parametrize("a", range(0, 16, 2))
def test_copy16_reads_each_valid_byte_once_and_fills_the_rest(a):
    """The staged loaders' copies of one 16-byte unit (copy16) at every
    even alignment and count of valid bytes: every byte of the unit
    written once (a read byte or a zero), every valid byte read, no byte
    past `valid` read, each piece aligned to its width."""
    for valid in range(-2, 18, 2):
        pieces = _copy16_pieces(a, valid)
        if pieces is None:                  # 2-byte aligned: load16
            continue
        written, read = [], []
        for off, w, n in pieces:
            assert (a + off) % w == 0
            written += range(off, off + w)
            read += range(off, off + n)
        assert sorted(written) == list(range(16))
        assert sorted(read) == list(range(min(max(valid, 0), 16)))


@pytest.mark.parametrize("a", range(0, 16, 2))
def test_load16_reads_no_block_without_a_valid_byte(a):
    """The staged loaders' reads (load16) at every even alignment and
    every count of valid bytes: each piece aligned to its width, inside
    the aligned 16-byte block of its first byte, which is a valid byte
    (so no read leaves the blocks that hold the row's values), and every
    valid byte read by some piece."""
    for valid in range(-2, 18, 2):
        pieces = _load16_pieces(a, valid)
        covered = set()
        for off, w in pieces:
            assert (a + off) % w == 0
            assert (a + off) // 16 == (a + off + w - 1) // 16
            assert off < valid
            covered |= set(range(off, off + w))
        assert set(range(min(max(valid, 0), 16))) <= covered
