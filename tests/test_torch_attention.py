"""The port's flash_attention against repro's Pallas kernel in interpret
mode and its plain version, on the same numpy inputs.

On the CPU the wrapper runs its plain version; the CUDA kernel is held
against the same plain version on the card by chip_smoke.py.  Tolerances
are repro's own (tests/test_kernels.py, flash_attention): 2e-5 for
float32, 2e-2 for bfloat16 (repro's kernel rounds P to bf16 before P.V,
the plain versions do not).
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
