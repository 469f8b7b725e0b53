"""The port's kernel entry points (repro_torch.kernels.ops) against
repro.kernels.ops: the same five names (which the package does not
re-export over its wrapper modules), and the same results on the CPU
with the same defaults.

Tolerances as in each kernel's own parity test: PAA, lower bounds and
refine distances at 1e-5 (float32 sums in another order), ed_argmin's
d^2 at 1e-4, attention at 2e-5.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels as kernels
from repro.kernels import ops as jops
from repro_torch.kernels import ops

torch.set_num_threads(2)

NAMES = ("summarize", "lb_distance", "ed_argmin", "refine_topk",
         "flash_attention")
# knobs that choose how repro runs its Pallas kernels, not what they give
TPU_ONLY = {"interpret", "lowering", "dma_depth", "block_q"}


def test_the_five_entry_points_are_repro_s():
    jnames = {n for n, f in vars(jops).items() if inspect.isfunction(f)
              and f.__module__ == jops.__name__}
    assert jnames == set(NAMES)
    for name in NAMES:
        assert inspect.isfunction(getattr(ops, name))
        assert name in ops.WRAPPERS and hasattr(ops.WRAPPERS[name],
                                                "launches")
        # no entry point shadows a wrapper module of the package
        assert not inspect.isfunction(getattr(kernels, name, None))
    for mod in ("lb_distance", "ed_argmin", "flash_attention"):
        assert inspect.ismodule(getattr(kernels, mod))


@pytest.mark.parametrize("name", NAMES)
def test_signatures_match_but_for_the_tpu_knobs(name):
    jp = inspect.signature(getattr(jops, name)).parameters
    tp = inspect.signature(getattr(ops, name)).parameters
    want = [(n, p.kind, p.default) for n, p in jp.items()
            if n not in TPU_ONLY]
    assert [(n, p.kind, p.default) for n, p in tp.items()] == want


def _walks(n, L=256, seed=0):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((n, L)), 1)
    return ((x - x.mean(1, keepdims=True)) / x.std(1, keepdims=True)
            ).astype(np.float32)


def _call(name, rng):
    """(repro's result, the port's result) for `name` with its defaults,
    each as a tuple of numpy arrays."""
    if name == "summarize":
        args = (_walks(40, seed=1),)
        kw = {}
    elif name == "lb_distance":
        lo = rng.standard_normal((50, 16)).astype(np.float32) - 0.5
        args = (rng.standard_normal((6, 16)).astype(np.float32), lo,
                lo + np.abs(rng.standard_normal((50, 16))).astype(np.float32))
        kw = {}
    elif name == "ed_argmin":
        args = (_walks(7, seed=2), _walks(300, seed=3))
        kw = {}
    elif name == "refine_topk":
        M, NL, Q, K, k = 8, 12, 5, 3, 4
        series = _walks(NL * M, seed=4)
        q = _walks(Q, seed=5)
        args = (q, (q * q).sum(1), series, (series * series).sum(1),
                np.stack([rng.permutation(NL)[:K] for _ in range(Q)]
                         ).astype(np.int32),
                rng.integers(0, 2, (Q, K)).astype(bool),
                np.full((Q, k), 1e30, np.float32), np.zeros((Q, k), np.int32))
        kw = {"leaf_capacity": M, "k": k}
    else:
        args = tuple(rng.standard_normal(s).astype(np.float32) for s in
                     ((1, 4, 128, 32), (1, 2, 128, 32), (1, 2, 128, 32)))
        kw = {}
    rj = jops.__dict__[name](*(jnp.asarray(a) for a in args), **kw,
                             interpret=True)
    rt = ops.__dict__[name](*(torch.from_numpy(np.ascontiguousarray(a))
                              for a in args), **kw)
    as_tuple = (lambda r: r if isinstance(r, tuple) else (r,))
    return ([np.asarray(a) for a in as_tuple(rj)],
            [t.numpy() for t in as_tuple(rt)])


@pytest.mark.parametrize("name", NAMES)
def test_entry_points_give_repro_s_results_on_the_cpu(name):
    rj, rt = _call(name, np.random.default_rng(7))
    tol = {"ed_argmin": 1e-4, "flash_attention": 2e-5}.get(name, 1e-5)
    assert len(rj) == len(rt)
    for a, b in zip(rj, rt):
        assert a.shape == b.shape
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, rtol=tol, atol=tol)
