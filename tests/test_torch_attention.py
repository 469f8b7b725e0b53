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
the float32 plain version.
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
def _attention_bf16_p(q, k, v, causal=True, window=0, split=True):
    """Attention as the bf16 kernel computes it: scores and softmax in
    float32, P.V from P as two bf16 operands P_hi + P_lo (split) or P
    rounded once to bf16 (as repro's kernel does), sums in float32, the
    output rounded to bf16."""
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
    hi = p.to(torch.bfloat16).float()
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
    P_hi + P_lo errs by ~2^-17 and stays within it."""
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


# ------------------------------------------- every head width repro takes
@pytest.mark.parametrize("dh", [40, 80, 96, 256, 320, 100, 36])
@pytest.mark.parametrize("bf16", [False, True])
def test_every_head_width_matches_pallas(dh, bf16):
    """Head widths outside the kernel's old set (32, 64, 128): 96
    (Phi-3-mini), 256 (Gemma 7B), 40 and 80 (padded to the next instance
    on the card), 320 (O in halves), and 100 and 36 (bfloat16 rows of
    200 and 72 bytes: the staged producer on the card), with GQA, against
    repro's kernel in interpret mode at the tolerances above."""
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
