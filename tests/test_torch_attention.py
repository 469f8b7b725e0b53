"""The port's flash_attention against repro's Pallas kernel in interpret
mode and its plain version, on the same numpy inputs.

On the CPU the wrapper runs its plain version; the CUDA kernel is held
against the same plain version on the card by chip_smoke.py.  Tolerances
are repro's own (tests/test_kernels.py, flash_attention): 2e-5 for
float32, 2e-2 for bfloat16 (repro's kernel rounds P to bf16 before P.V,
the plain versions do not).

The CUDA kernel's bf16 route feeds P to the tensor cores as two bf16
operands, P = P_hi + P_lo.  `_attention_bf16_p` repeats that arithmetic
with plain torch, so that the choice is held here, on the CPU, to the
limit chip_smoke.py holds a bf16 output to: 2^-8 |plain| + 2e-5 around
the float32 plain version.  `_tiled` repeats the tensor-core kernels'
loop (64-key tiles, a stale row max moved only past +8 in log2 units),
with three TF32 products a term for the float32 route at dh 129-256;
`_split_kv` that route's copies of K and V, lane by lane.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

torch.set_num_threads(2)


def _qkv(B, Hq, Hkv, T, dh, S=None, seed=0):
    rng = np.random.default_rng(seed)
    S = T if S is None else S
    return (rng.standard_normal((B, Hq, T, dh)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, dh)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, dh)).astype(np.float32))


def _both(arrays, bf16=False, block_q=64, **kw):
    """repro's kernel (interpret mode) and the port's entry point, as f32
    numpy."""
    if bf16:
        arrays = [a.astype(ml_dtypes.bfloat16) for a in arrays]
        ts = [torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
              for a in arrays]
    else:
        ts = [torch.from_numpy(a) for a in arrays]
    oj = jops.flash_attention(*[jnp.asarray(a) for a in arrays],
                              block_q=block_q, interpret=True, **kw)
    ot = ops.flash_attention(*ts, **kw)
    assert ot.dtype == ts[0].dtype and ot.shape == ts[0].shape
    return np.asarray(oj, np.float32), ot.float().numpy()


@pytest.mark.parametrize("B,Hq,Hkv,T,dh", [(2, 4, 2, 128, 64),
                                           (1, 8, 8, 256, 32),
                                           (2, 2, 1, 64, 128),
                                           (1, 4, 4, 512, 64)])
def test_flash_attention_matches_pallas(B, Hq, Hkv, T, dh):
    oj, ot = _both(_qkv(B, Hq, Hkv, T, dh, seed=T + dh))
    np.testing.assert_allclose(ot, oj, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [32, 128])
def test_flash_attention_sliding_window_matches_pallas(window):
    oj, ot = _both(_qkv(1, 2, 2, 256, 64, seed=window), window=window)
    np.testing.assert_allclose(ot, oj, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bf16", [False, True])
def test_flash_attention_dtypes_match_pallas(bf16):
    oj, ot = _both(_qkv(1, 2, 2, 128, 64, seed=3), bf16=bf16, block_q=128)
    tol = 2e-2 if bf16 else 2e-5
    np.testing.assert_allclose(ot, oj, rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_a_row_that_sees_no_key_gets_the_mean_of_v(causal):
    """T=256 queries over S=64 keys with window 32: rows t >= 95 see no
    key.  With the finite -1e30 mask both packages give such a row the
    mean of V over all S keys, not NaN."""
    q, k, v = _qkv(1, 2, 2, 256, 64, S=64, seed=11)
    oj, ot = _both((q, k, v), causal=causal, window=32)
    np.testing.assert_allclose(ot, oj, rtol=2e-5, atol=2e-5)
    rj = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=32))
    np.testing.assert_allclose(ot, rj, rtol=2e-5, atol=2e-5)
    assert np.isfinite(ot).all()
    empty = np.arange(256) >= 64 + 32 - 1
    mean_v = v.mean(axis=2)[:, :, None, :]
    np.testing.assert_allclose(ot[:, :, empty], np.broadcast_to(
        mean_v, ot[:, :, empty].shape), rtol=2e-5, atol=2e-5)


def test_a_ragged_t_is_taken_without_a_query_tiling():
    """T=200 is no multiple of repro's default block_q=128: repro needs a
    block_q that tiles T (40 here), the port takes T as it is, because its
    kernel masks the ragged edge.  The result is the same."""
    oj, ot = _both(_qkv(1, 4, 2, 200, 32, seed=13), block_q=40, window=72)
    np.testing.assert_allclose(ot, oj, rtol=2e-5, atol=2e-5)


def test_plain_version_matches_repro_ref_with_gqa_and_a_window():
    q, k, v = _qkv(2, 6, 3, 96, 32, S=80, seed=5)
    rt = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=True, window=20)
    rj = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, window=20)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=2e-5,
                               atol=2e-5)


def test_heads_that_do_not_group_raise():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 3, 64, 32, seed=1))
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q, k, v)
    with pytest.raises(AssertionError):           # repro asserts the same
        jops.flash_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                             interpret=True)


# ----------------------------------------------- the kernel's arithmetic
def _trunc_bf16(x):
    """float32 x with its lower 16 bits cleared: the bf16 its upper half
    is (rounded toward zero), as a PRMT of the upper halves takes it."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


def _attention_bf16_p(q, k, v, causal=True, window=0, split=True):
    """Attention as the bf16 kernel computes it: scores and softmax in
    float32, P.V from P as two bf16 operands P_hi + P_lo (split, as
    csrc/flash_attention.cu split2: P_hi the upper half of P, P_lo = P -
    P_hi rounded) or P rounded once to bf16 (as repro's kernel does), sums
    in float32, the output rounded to bf16."""
    B, Hq, T, dh = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    s = torch.einsum("bkgtd,bksd->bkgts",
                     q.float().reshape(B, Hkv, Hq // Hkv, T, dh),
                     k.float()) * dh ** -0.5
    t, j = torch.arange(T)[:, None], torch.arange(S)[None]
    seen = (t >= j) if causal else torch.ones(T, S, dtype=torch.bool)
    if window:
        seen &= j > t - window
    p = torch.exp(s.masked_fill(~seen, ref.NEG_INF)
                  - s.masked_fill(~seen, ref.NEG_INF).amax(-1, keepdim=True))
    hi = _trunc_bf16(p) if split else p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float() if split else 0 * hi
    o = sum(torch.einsum("bkgts,bksd->bkgtd", part, v.float())
            for part in (hi, lo)) / p.sum(-1, keepdim=True)
    return o.reshape(B, Hq, T, dh).to(torch.bfloat16)


def _excess(out, q, k, v, **kw):
    """How far out lies beyond 2^-8 |plain| + 2e-5 (<= 0: within)."""
    plain = ref.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    return ((out.float() - plain).abs() - 2 ** -8 * plain.abs()
            - 2e-5).max().item()


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def test_p_in_two_bf16_halves_holds_the_card_limit_where_one_does_not():
    """Keys in pairs that nearly coincide and values in pairs v, -v: each
    row's output is a small remainder of terms that cancel.  One bf16 P
    errs by 2^-9 of each term, far beyond the limit on that remainder;
    P_hi + P_lo errs by at most 2^-16 and stays within it."""
    rng = np.random.default_rng(21)
    T, dh = 64, 32
    k = rng.standard_normal((1, 1, T, dh)).astype(np.float32)
    k[..., 1::2, :] = k[..., 0::2, :] + 0.02 * rng.standard_normal(
        (1, 1, T // 2, dh))
    v = rng.standard_normal((1, 1, T, dh)).astype(np.float32)
    v[..., 1::2, :] = -v[..., 0::2, :]
    q = _bf16(rng.standard_normal((1, 1, T, dh)).astype(np.float32))
    k, v = _bf16(k), _bf16(v)
    assert _excess(_attention_bf16_p(q, k, v), q, k, v) <= 0
    assert _excess(_attention_bf16_p(q, k, v, split=False), q, k, v) > 1e-4


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16),
                                           (False, 32)])
def test_p_in_two_bf16_halves_holds_the_card_limit_with_gqa(causal, window):
    """Random inputs with GQA (Hq 4 over Hkv 2), windows and the empty rows
    of a non-causal window over S < T: the split stays within the limit
    (one bf16 P already misses it at rows with few keys)."""
    q, k, v = (_bf16(a) for a in _qkv(2, 4, 2, 128, 64, S=96, seed=8))
    kw = dict(causal=causal, window=window)
    assert _excess(_attention_bf16_p(q, k, v, **kw), q, k, v, **kw) <= 0
    assert _excess(_attention_bf16_p(q, k, v, split=False, **kw), q, k, v,
                   **kw) > 0


def test_the_split_holds_the_card_limit_at_phi3_width():
    """At Phi-3-mini's head width (dh 96, Hq = Hkv, causal, T 512: the
    tc96 instance's shape) the split stays within 2^-8 |plain| + 2e-5,
    where one bf16 P misses the limit."""
    q, k, v = (_bf16(a) for a in _qkv(1, 4, 4, 512, 96, seed=96))
    assert _excess(_attention_bf16_p(q, k, v), q, k, v) <= 0
    assert _excess(_attention_bf16_p(q, k, v, split=False), q, k, v) > 0


def test_truncated_high_half_bounds_the_split_error():
    """split2, element by element on P in (2^-40, 2^8] (the stale max lets
    P reach 2^8): P_hi has P's upper 16 bits, P - P_hi is exact in
    float32, P_hi and P_lo are bf16 values, and |P - (P_hi + P_lo)| <=
    2^-16 P (2^-17 P where P_hi is rounded too)."""
    rng = np.random.default_rng(3)
    p = torch.from_numpy(np.exp2(rng.uniform(-40, 8, 1 << 16))
                         .astype(np.float32))
    hi = _trunc_bf16(p)
    assert torch.equal(hi, hi.to(torch.bfloat16).float())
    assert bool((p.view(torch.int32) >> 16 == hi.view(torch.int32) >> 16)
                .all())
    assert torch.equal((p - hi).double(), p.double() - hi.double())
    lo = (p - hi).to(torch.bfloat16).float()
    assert torch.equal(lo, lo.to(torch.bfloat16).float())
    err = (p.double() - hi.double() - lo.double()).abs() / p.double()
    assert float(err.max()) <= 2 ** -16
    hr = p.to(torch.bfloat16).float()
    lr = (p - hr).to(torch.bfloat16).float()
    err_r = (p.double() - hr.double() - lr.double()).abs() / p.double()
    assert float(err_r.max()) <= 2 ** -17


# ------------------------------------------- every head width repro takes
@pytest.mark.parametrize("dh", [40, 80, 96, 256, 320, 100, 36, 520, 576])
@pytest.mark.parametrize("bf16", [False, True])
def test_every_head_width_matches_pallas(dh, bf16):
    """Head widths outside the kernel's old set (32, 64, 128): 96
    (Phi-3-mini), 256 (Gemma 7B), 40 and 80 (padded to the next instance
    on the card), 320 (O in halves), 100 and 36 (bfloat16 rows of 200
    and 72 bytes: the staged producer on the card), and 520 and 576 (O
    in chunks on the card; 576 DeepSeek-V2-Lite's latent of 512 + 64),
    with GQA, against repro's kernel in interpret mode at the tolerances
    above."""
    oj, ot = _both(_qkv(1, 4, 2, 128, dh, seed=dh), bf16=bf16)
    tol = 2e-2 if bf16 else 2e-5
    np.testing.assert_allclose(ot, oj, rtol=tol, atol=tol)


@pytest.mark.parametrize("dh", [8, 36, 40, 80, 96, 100, 136, 256])
def test_zero_columns_change_nothing(dh):
    """The padded instances' premise: q, k, v padded with zero columns to
    the instance's width (scores still scaled by the real dh^-0.5) give
    the scores and the real columns of O to float32 rounding (the sums
    only gain zero terms), and zeros past them."""
    from repro_torch.kernels import flash_attention as fa
    width = next((w for w in fa.INSTANCES if w >= dh), dh)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 64, dh, seed=dh))
    pad = [torch.nn.functional.pad(t, (0, width - dh)) for t in (q, k, v)]
    want = ref.flash_attention_ref(q, k, v, causal=True, window=24)
    s = torch.einsum("bhtd,bhsd->bhts", pad[0],
                     pad[1].repeat_interleave(2, 1)) * dh ** -0.5
    s0 = torch.einsum("bhtd,bhsd->bhts", q,
                      k.repeat_interleave(2, 1)) * dh ** -0.5
    np.testing.assert_allclose(s.numpy(), s0.numpy(), rtol=1e-6, atol=1e-6)
    got = _attention_scaled(*pad, dh ** -0.5, causal=True, window=24)
    assert torch.equal(got[..., dh:], torch.zeros_like(got[..., dh:]))
    np.testing.assert_allclose(got[..., :dh].numpy(), want.numpy(),
                               rtol=2e-6, atol=2e-6)


def _attention_scaled(q, k, v, scale, causal=True, window=0):
    """The plain attention with the scale given (the padded width's own
    would be width^-0.5)."""
    G = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    T, S = q.shape[2], k.shape[2]
    s = torch.einsum("bhtd,bhsd->bhts", q, k) * scale
    t, j = torch.arange(T)[:, None], torch.arange(S)[None]
    seen = (t >= j) if causal else torch.ones(T, S, dtype=torch.bool)
    if window:
        seen &= j > t - window
    p = torch.softmax(s.masked_fill(~seen, ref.NEG_INF), -1)
    return torch.einsum("bhts,bhsd->bhtd", p, v)


def test_many_heads_answer_on_the_cpu():
    """B * Hq past 65,535 (the grid's old y limit): the port answers, as
    repro's kernel does, here through the plain version at T 4."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 65600, 65600, 4, 8,
                                                    seed=2))
    out = ops.flash_attention(q, k, v)
    want = ref.flash_attention_ref(q[:, :64], k[:, :64], v[:, :64])
    assert out.shape == q.shape and bool(torch.isfinite(out).all())
    assert torch.equal(out[:, :64], want)


# ---------------------------------------------- the staged route's copies
def _pad_rows(q, k, v, ld):
    """csrc/flash_attention.cu pad_rows on (rows, dh) matrices q, k and v
    (k and v of one shape), thread by thread: 16-byte pieces u of the
    copies back to back (row R = u // P of q's rows, then k's, then v's;
    columns 8 (u % P) .., P = ld / 8), each the values load16 reads
    from its input's row (those before dh; zeros past it), written once
    into one (rows_q + 2 rows_kv, ld) buffer.  Asserts no piece is
    written twice and every piece is 16-byte aligned in the buffer."""
    rows_q, dh = q.shape
    rows_kv = k.shape[0]
    per = ld // 8
    out = np.full((rows_q + 2 * rows_kv, ld), np.nan, np.float32)
    for u in range((rows_q + 2 * rows_kv) * per):
        r, col = u // per, u % per * 8
        src = (q[r] if r < rows_q else k[r - rows_q]
               if r < rows_q + rows_kv else v[r - rows_q - rows_kv])
        assert ((r * ld + col) * 2) % 16 == 0
        assert np.isnan(out[r, col:col + 8]).all(), "a piece written twice"
        valid = max(min((dh - col) * 2, 16), 0)
        piece = np.zeros(8, np.float32)
        piece[:valid // 2] = src[col:col + valid // 2]
        out[r, col:col + 8] = piece
    return out


@pytest.mark.parametrize("dh", [1, 30, 36, 90, 100, 101, 102, 250, 300,
                                 445, 509])
def test_padded_copies_hold_every_row_whole(dh):
    """The staged route (bfloat16 rows that are not whole 16-byte pieces)
    copies q, k and v into rows of ld = dh rounded up to 8 values, whole
    16-byte pieces that TMA takes, back to back in one buffer: every
    value at its row and column, the pad zeros, each piece written once; the maps over the copies (dh
    wide, rows ld apart) then read what maps over the tensors would, and
    the head strides (T ld, S ld values) are multiples of 16 bytes at any
    T and S."""
    ld = -(-dh // 8) * 8
    assert (ld * 2) % 16 == 0 and ld - dh < 8
    rng = np.random.default_rng(dh)
    q = rng.standard_normal((37, dh)).astype(np.float32)
    k, v = rng.standard_normal((2, 11, dh)).astype(np.float32)
    out = _pad_rows(q, k, v, ld)
    np.testing.assert_array_equal(out[:, :dh], np.concatenate([q, k, v]))
    assert not out[:, dh:].any()
    for rows_n in (1, 999, 1024):
        assert (rows_n * ld * 2) % 16 == 0


# ------------------------------- the tensor-core loop at head width 256
def _tf32(x, mode):
    """float32 x as TF32 (10 mantissa bits): "rna" rounds to the nearest,
    ties away from zero (cvt.rna.tf32.f32, the kernels' hi), "trunc"
    masks the low 13 bits (how the tensor core reads a float32 operand)."""
    b = x.contiguous().view(torch.int32)
    if mode == "rna":
        b = b + 0x1000
    return (b & ~0x1FFF).view(torch.float32)


def _mm3(a, b):
    """a @ b in three TF32 products (3xTF32): hi = rna(x), lo = x - hi,
    each operand read truncated; a_hi.b_hi + a_lo.b_hi + a_hi.b_lo."""
    ah, bh = _tf32(a, "rna"), _tf32(b, "rna")
    t = lambda x: _tf32(x, "trunc")  # noqa: E731
    return t(ah) @ t(bh) + t(a - ah) @ t(bh) + t(ah) @ t(b - bh)


def _mm1(a, b):
    """a @ b in one TF32 product, each operand read truncated."""
    return _tf32(a, "trunc") @ _tf32(b, "trunc")


def _mm_bf16_p(p, v):
    """P.V as the bf16 kernel issues it: P as two bf16 halves."""
    hi = p.to(torch.bfloat16).float()
    return (hi + (p - hi).to(torch.bfloat16).float()) @ v


def _tiled(q, k, v, qk, pv, causal=True, window=0, bn=64, lazy=8.0):
    """The tensor-core kernels' loop (csrc/flash_attention.cu, tc and tf)
    on float32 q (B, Hq, T, dh) and k, v (B, Hkv, S, dh): tiles of bn
    keys, scores qk(q, K^T) in log2 units (dh^-0.5 log2 e), masked keys
    -1e30; a row's max m moves only where a tile's max exceeds it by more
    than `lazy` (online::Rows), p = exp2(x - m), O = O alpha + pv(p, V),
    l = l alpha + sum p.  Returns (O / l, the tiles at which each row's
    max moved, the largest p)."""
    B, Hq, T, dh = q.shape
    G = Hq // k.shape[1]
    k, v = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    S = k.shape[2]
    c = dh ** -0.5 * np.log2(np.e)
    t = torch.arange(T)[:, None]
    m = torch.full((B, Hq, T, 1), -np.inf)
    l = torch.zeros(B, Hq, T, 1)
    o = torch.zeros(B, Hq, T, dh)
    moved = torch.zeros(B, Hq, T, dtype=torch.int64)
    p_max = 0.0
    for k0 in range(0, S, bn):
        j = torch.arange(k0, min(k0 + bn, S))[None]
        x = qk(q, k[:, :, k0:k0 + bn].transpose(-1, -2)) * c
        seen = (t >= j) if causal else torch.ones(T, j.shape[1],
                                                  dtype=torch.bool)
        if window:
            seen &= j > t - window
        x = x.masked_fill(~seen, ref.NEG_INF)
        mx = x.amax(-1, keepdim=True)
        up = mx > m + lazy
        mn = torch.where(up, mx, m)
        alpha = torch.exp2(m - mn)
        p = torch.exp2(x - mn)
        o = o * alpha + pv(p, v[:, :, k0:k0 + bn])
        l = l * alpha + p.sum(-1, keepdim=True)
        m = mn
        moved += up[..., 0]
        p_max = max(p_max, p.max().item())
    return o / l, moved, p_max


def _excess_f32(out, q, k, v, **kw):
    """How far out lies beyond rtol + atol 2e-5 around the float32 plain
    version (<= 0: within), chip_smoke.py's float32 limit."""
    plain = ref.flash_attention_ref(q, k, v, **kw)
    return ((out - plain).abs() - 2e-5 * plain.abs() - 2e-5).max().item()


def test_3xtf32_holds_the_float32_limit_where_one_tf32_product_does_not():
    """The float32 route at dh 129-256 (tf256) on the tensor cores:
    three TF32 products a term for S = Q.K^T and for O += P.V hold the
    float32 limit at dh 256, T 1024, causal, GQA, on normal draws (as
    chip_smoke.py draws them); one TF32 product a term misses it by far."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 1024, 256,
                                                    seed=256))
    out, moved, p_max = _tiled(q, k, v, _mm3, _mm3)
    assert _excess_f32(out, q, k, v) <= 0
    assert p_max <= 2 ** 8
    one, _, _ = _tiled(q, k, v, _mm1, _mm1)
    assert _excess_f32(one, q, k, v) > 1e-4


@pytest.mark.parametrize("case", ["rising", "window", "empty", "gqa"])
def test_the_stale_max_holds_the_bf16_limit(case):
    """O and l on a stale row max that moves only where a tile's max
    passes it by more than 8 (log2 units), so every P <= 2^8, with P.V in
    two bf16 halves, held to the float32 plain version under the bf16
    limit (2^-8 |o| + 2e-5): a row whose max rises past the threshold on
    every tile (scores growing by 12.8 a tile of 64 keys), a window over
    a ragged T = S = 200, rows that see no key (T 256 over S 64, window
    32, not causal: the mean of V), and GQA on normal draws, where the
    max stays after the first tile on most rows."""
    kw = dict(causal=True, window=0)
    if case == "rising":
        T, dh = 512, 64
        rng = np.random.default_rng(5)
        q = np.zeros((1, 2, T, dh), np.float32)
        k = 0.1 * rng.standard_normal((1, 2, T, dh)).astype(np.float32)
        q[..., 0] = 1.0
        # slope 0.2 a key in log2 units: 64 * 0.2 = 12.8 > 8 a tile
        k[..., 0] = 0.2 * np.arange(T) / (dh ** -0.5 * np.log2(np.e))
        v = rng.standard_normal((1, 2, T, dh)).astype(np.float32)
        q, k, v = (_bf16(a) for a in (q, k, v))
    elif case == "window":
        q, k, v = (_bf16(a) for a in _qkv(1, 4, 2, 200, 64, seed=7))
        kw = dict(causal=True, window=40)
    elif case == "empty":
        q, k, v = (_bf16(a) for a in _qkv(1, 2, 2, 256, 64, S=64, seed=9))
        kw = dict(causal=False, window=32)
    else:
        q, k, v = (_bf16(a) for a in _qkv(2, 4, 2, 256, 96, seed=12))
    out, moved, p_max = _tiled(q.float(), k.float(), v.float(),
                               lambda a, b: a @ b, _mm_bf16_p, **kw)
    assert _excess(out.to(torch.bfloat16), q, k, v, **kw) <= 0
    assert p_max <= 2 ** 8
    tiles = -(-k.shape[2] // 64)
    if case == "rising":
        # each row's every full tile it sees moves its max
        full = torch.arange(63, 512, 64)
        assert torch.equal(moved[..., full],
                           (full // 64 + 1).expand_as(moved[..., full]))
    elif case == "empty":
        assert bool((moved == 1).all())
    else:
        assert bool((moved < tiles).any()) and int(moved.min()) >= 1


# ------------------------------------- O in chunks past head width 512
def _chunked(q, k, v, width, causal=True, window=0, piece=64, bn=64,
             lazy=8.0):
    """The bfloat16 chunk kernel (csrc/flash_attention.cu, chunk::) on
    float32 q (B, Hq, T, dh) and k, v (B, Hkv, S, dh): for each chunk of
    `width` columns of O, 64-row query blocks whose two consumers take
    alternate key tiles of bn; a tile's scores summed over dh in pieces
    of `piece` columns, in order, scaled into log2 units and masked as
    _tiled does; the stale max; P.V from P_hi + P_lo (split2) against the
    chunk's columns of V; the consumers' O, max and sum merged at the end
    (tf::'s merge).  Returns O as float32."""
    B, Hq, T, dh = q.shape
    G = Hq // k.shape[1]
    k, v = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    S = k.shape[2]
    c = dh ** -0.5 * np.log2(np.e)
    out = torch.zeros(B, Hq, T, dh)
    t = torch.arange(T)[:, None]
    for c0 in range(0, dh, width):
        vc = v[..., c0:c0 + width]
        parts = []
        for w in range(2):                       # the two consumers
            m = torch.full((B, Hq, T, 1), -np.inf)
            l = torch.zeros(B, Hq, T, 1)
            o = torch.zeros(B, Hq, T, vc.shape[-1])
            for k0 in range(w * bn, S, 2 * bn):
                j = torch.arange(k0, min(k0 + bn, S))[None]
                x = torch.zeros(B, Hq, T, j.shape[1])
                for p0 in range(0, dh, piece):
                    x = x + q[..., p0:p0 + piece] @ k[
                        :, :, k0:k0 + bn, p0:p0 + piece].transpose(-1, -2)
                x = x * c
                seen = (t >= j) if causal else torch.ones(
                    T, j.shape[1], dtype=torch.bool)
                if window:
                    seen &= j > t - window
                x = x.masked_fill(~seen, ref.NEG_INF)
                mx = x.amax(-1, keepdim=True)
                mn = torch.where(mx > m + lazy, mx, m)
                alpha = torch.exp2(m - mn)
                p = torch.exp2(x - mn)
                hi = _trunc_bf16(p)
                lo = (p - hi).to(torch.bfloat16).float()
                o = o * alpha + hi @ vc[:, :, k0:k0 + bn] \
                    + lo @ vc[:, :, k0:k0 + bn]
                l = l * alpha + p.sum(-1, keepdim=True)
                m = mn
            parts.append((o, m, l))
        (o0, m0, l0), (o1, m1, l1) = parts
        mm = torch.maximum(m0, m1)
        a, b = torch.exp2(m0 - mm), torch.exp2(m1 - mm)
        b = torch.where(torch.isinf(m1), torch.zeros_like(b), b)
        out[..., c0:c0 + width] = (o0 * a + o1 * b) / (l0 * a + l1 * b)
    return out


@pytest.mark.parametrize("dh,width,causal,window", [
    (576, 192, True, 0), (576, 192, True, 100), (520, 192, False, 48),
    (640, 256, True, 0)])
def test_chunks_of_o_hold_repros_flash_attention(dh, width, causal, window):
    """The chunked design past dh 512 (O in chunks of `width` columns,
    the scores over dh in 64-column pieces, P in two bf16 halves, two
    consumers on alternate key tiles merged at the end), on bf16 inputs
    with GQA, held to repro's flash_attention on the same values in
    float32 (its kernel in interpret mode) within the card's bf16 limit,
    2^-8 |o| + 2e-5, after the output's rounding to bf16; and to the
    port's plain version alike."""
    q, k, v = (_bf16(a) for a in _qkv(1, 4, 2, 256, dh, seed=dh + window))
    kw = dict(causal=causal, window=window)
    out = _chunked(q.float(), k.float(), v.float(), width, **kw)
    out = out.to(torch.bfloat16).float()
    want = np.asarray(jops.flash_attention(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)), block_q=64,
        interpret=True, **kw), np.float32)
    excess = (np.abs(out.numpy() - want) - 2 ** -8 * np.abs(want)
              - 2e-5).max()
    assert excess <= 0
    assert _excess(out.to(torch.bfloat16), q, k, v, **kw) <= 0


# ------------------------------------------- the TF32 route's split copies
def _key_at(pos):
    """csrc/flash_attention.cu tf::key_at: the key at V^T position pos,
    keys 0, 2, 4, 6, 1, 3, 5, 7 of each group of 8."""
    pos = np.asarray(pos)
    low = pos & 7
    return (pos & ~7) | np.where(low < 4, 2 * (low & 3), 2 * (low & 3) + 1)


def _split_kv(k, v):
    """tf::split_kv on (heads, S, dh) float32 k and v, block by block and
    lane by lane (blocks of 32 keys x 32 columns, threads (tx, ty) of 32
    x 8, four rows each): K_hi, K_lo (heads, S, dhp) and V^T_hi, V^T_lo
    (heads, dh, sp), each element written once (the buffers start as NaN,
    as scratch may)."""
    heads, S, dh = k.shape
    dhp, sp = -(-dh // 4) * 4, -(-S // 8) * 8
    khi, klo = (np.full((heads, S, dhp), np.nan, np.float32) for _ in "kl")
    vhi, vlo = (np.full((heads, dh, sp), np.nan, np.float32) for _ in "kl")
    tx = np.arange(32)

    def rna(x):
        return _tf32(torch.from_numpy(np.ascontiguousarray(x)),
                     "rna").numpy()

    def put(buf, idx, vals):
        assert np.isnan(buf[idx]).all(), "written twice"
        buf[idx] = vals
    for h in range(heads):
        for k0 in range(0, sp, 32):
            for d0 in range(0, dhp, 32):
                tile = np.zeros((32, 32), np.float32)
                for ty in range(8):
                    for i in range(4):
                        key, d = k0 + ty + 8 * i, d0 + tx
                        ok = (d < dh) & (key < S)
                        x = np.where(ok, k[h, min(key, S - 1),
                                           np.minimum(d, dh - 1)], 0)
                        x = x.astype(np.float32)
                        w = d < dhp
                        hi = rna(x)
                        if key < S:
                            put(khi, (h, key, d[w]), hi[w])
                            put(klo, (h, key, d[w]), (x - hi)[w])
                        tile[ty + 8 * i] = np.where(ok, v[h, min(key, S - 1),
                                                         np.minimum(d,
                                                                    dh - 1)],
                                                    0)
                for ty in range(8):
                    for i in range(4):
                        d, col = d0 + ty + 8 * i, k0 + tx
                        w = (d < dh) & (col < sp)
                        if not w.any():
                            continue
                        x = tile[_key_at(tx), ty + 8 * i]
                        hi = rna(x)
                        put(vhi, (h, d, col[w]), hi[w])
                        put(vlo, (h, d, col[w]), (x - hi)[w])
    return khi, klo, vhi, vlo


@pytest.mark.parametrize("S,dh", [(64, 256), (45, 130), (100, 255)])
def test_split_copies_hold_k_and_the_permuted_v(S, dh):
    """The TF32 route's prep kernel: K_hi + K_lo = K exactly, K_hi
    representable in TF32, columns dh .. dhp - 1 zeros (rows of whole
    16-byte pieces for TMA); V^T_hi + V^T_lo at row d, position c is V
    at key key_at(c), zeros past S (to sp, S rounded up to 8); every
    element written once."""
    rng = np.random.default_rng(S + dh)
    k, v = rng.standard_normal((2, 2, S, dh)).astype(np.float32)
    khi, klo, vhi, vlo = _split_kv(k, v)
    dhp, sp = khi.shape[2], vhi.shape[2]
    assert dhp % 4 == 0 and sp % 8 == 0 and dhp - dh < 4 and sp - S < 8
    assert not np.isnan(khi).any() and not np.isnan(vhi).any()
    np.testing.assert_array_equal((khi + klo)[..., :dh], k)
    assert not khi[..., dh:].any() and not klo[..., dh:].any()
    assert not (khi.view(np.int32) & 0x1FFF).any()
    keys = _key_at(np.arange(sp))
    want = np.zeros((2, dh, sp), np.float32)
    inside = keys < S
    want[:, :, inside] = v[:, keys[inside], :].transpose(0, 2, 1)
    np.testing.assert_array_equal(vhi + vlo, want)


def test_accumulator_fragments_times_permuted_v_give_p_v():
    """P.V on the TF32 route takes P's A fragments straight from the S
    accumulator: a thread holds keys 8 j + 2 t4 and + 1 of rows g and g +
    8 (per warp of 16 rows), and the tf32 A fragment of k8 slice j wants
    keys t4 and t4 + 4: (s[4j], s[4j + 2], s[4j + 1], s[4j + 3]) at (g,
    t4), (g + 8, t4), (g, t4 + 4), (g + 8, t4 + 4).  With V^T's keys
    permuted by the split copy, the product of those A tiles with V^T's
    slices is P @ V."""
    rng = np.random.default_rng(3)
    S, dh = 64, 130
    p = rng.random((64, S))
    v = rng.standard_normal((1, S, dh)).astype(np.float32)
    _, _, vhi, vlo = _split_kv(v, v)
    vt = (vhi + vlo)[0].astype(np.float64)            # (dh, sp)
    acc = np.empty((4, 32, S // 2))                   # warp, lane, s[]
    for w in range(4):
        for lane in range(32):
            g, t4 = lane // 4, lane % 4
            for j in range(S // 8):
                for e in range(4):
                    acc[w, lane, 4 * j + e] = p[16 * w + g + 8 * (e >= 2),
                                                8 * j + 2 * t4 + (e & 1)]
    o = np.zeros((64, dh))
    for kk in range(S // 8):
        a = np.empty((64, 8))
        for w in range(4):
            for lane in range(32):
                g, t4 = lane // 4, lane % 4
                s = acc[w, lane]
                r = 16 * w + g
                a[r, t4], a[r + 8, t4] = s[4 * kk], s[4 * kk + 2]
                a[r, t4 + 4], a[r + 8, t4 + 4] = s[4 * kk + 1], s[4 * kk + 3]
        o += a @ vt[:, 8 * kk:8 * kk + 8].T
    np.testing.assert_allclose(o, p @ v[0].astype(np.float64), rtol=1e-12,
                               atol=1e-12)
