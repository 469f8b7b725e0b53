"""refine_search's fold by selection and merge, held to the rank rule.

`ref.select_merge_fold` is the plain model of the fold the refine_search
kernel runs (csrc/refine.cu, namespace search): the candidates below the
k-th best cut into the runs of a cluster's CTAs, each run sorted by
(distance, union index) and cut to k, the runs merged, then buffer slots
and candidates placed by their merge ranks, the buffer whole or in
slices over the cluster.  Held here on the CPU, on the same numpy inputs:

* bit for bit (distances by their bits) to the port's
  `ref.refine_topk_ref` and to repro's `refine_topk_ref`, whose folds
  take the candidates as distances of a zero query to rows of the given
  norms;
* entries and distances equal to repro's `_rank_select`, the Pallas
  kernels' rank rule, at small unions;
* at k 1, 10, 2000, 5000 and 20,000 and n from 0 to 16,384, with the
  ties a fold meets: duplicated rows, candidates equal to buffer
  entries, ties at the k-th value, an all-1e30 buffer, and -0.0 beside
  +0.0 (equal, as `<` orders them: the port's stable sort keeps each
  one's bits, repro's top_k orders -0.0 first and `_rank_select` sums
  the sign away, so that case is held to the port's fold bit for bit
  and to `_rank_select` by value);
* the same for one run or eight and a whole buffer or eight slices.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.refine import _rank_select
from repro_torch.kernels import ref

torch.set_num_threads(2)

BIG = np.float32(1e30)
L = 4


def _buffer(rng, Q, k, kind):
    """(Q, k) ascending buffer and its entries: all 1e30 (the empty
    buffer, entries 0), or few distinct values (long runs of ties) with a
    1e30 tail."""
    if kind == "empty":
        return np.full((Q, k), BIG), np.zeros((Q, k), np.int32)
    d = np.sort(rng.integers(0, 6, (Q, k)).astype(np.float32), axis=1)
    d[:, k - k // 4:] = BIG
    return d, rng.permutation(Q * k).reshape(Q, k).astype(np.int32) + 7


def _candidates(rng, bd, n, kind):
    """(Q, n) candidate distances in union order: integers 0-7 (each
    value many times: duplicated rows), some copied from the buffer
    (equal to its entries, the k-th value among them)."""
    Q = bd.shape[0]
    cd = rng.integers(0, 8, (Q, n)).astype(np.float32)
    if kind == "spread":
        cd += rng.random((Q, n)).astype(np.float32)
    finite = bd[bd < BIG]
    if finite.size and n:
        at = rng.random((Q, n)) < 0.25
        cd[at] = rng.choice(finite, int(at.sum()))
    return cd


def _fold_inputs(cd, M):
    """refine_topk_ref's arguments whose round's distances are cd: a zero
    query against rows whose norms are cd, query i's K = n / M leaves its
    own, all alive; and the candidates' entries."""
    Q, n = cd.shape
    K = n // M
    leaf_ids = (np.arange(Q)[:, None] * K + np.arange(K)).astype(np.int32)
    entry = (leaf_ids[..., None] * M + np.arange(M)).reshape(Q, n)
    norms = np.zeros(Q * n, np.float32)
    norms[entry.reshape(-1)] = cd.reshape(-1)
    return (np.zeros((Q, L), np.float32), np.zeros(Q, np.float32),
            np.zeros((Q * n, L), np.float32), norms, leaf_ids,
            np.ones((Q, K), bool)), entry.astype(np.int32)


def _bits(d):
    return np.asarray(d, np.float32).view(np.int32)


def _model(bd, be, cd, ce, k, M, runs, slices):
    d, e = ref.select_merge_fold(torch.from_numpy(bd), torch.from_numpy(be),
                                 torch.from_numpy(cd), torch.from_numpy(ce),
                                 k, leaf_capacity=M, runs=runs, slices=slices)
    return d.numpy(), e.numpy()


CASES = [  # (k, K, M): n = K * M candidates
    (1, 1, 64), (1, 64, 256), (10, 8, 64), (10, 64, 256), (2000, 8, 64),
    (2000, 64, 256), (5000, 8, 64), (5000, 64, 256), (20000, 8, 64),
    (20000, 64, 256)]


@pytest.mark.parametrize("kind", ["empty", "ties"])
@pytest.mark.parametrize("cands", ["duplicated", "spread"])
@pytest.mark.parametrize("k,K,M", CASES)
def test_fold_is_refine_topk_refs_bit_for_bit(k, K, M, kind, cands):
    rng = np.random.default_rng(k + K + M)
    Q = 2
    bd, be = _buffer(rng, Q, k, kind)
    cd = _candidates(rng, bd, K * M, cands)
    args, ce = _fold_inputs(cd, M)
    wd, we = ref.refine_topk_ref(*map(torch.from_numpy, args),
                                 torch.from_numpy(bd), torch.from_numpy(be),
                                 leaf_capacity=M, k=k)
    jd, je = jref.refine_topk_ref(*map(jnp.asarray, args), jnp.asarray(bd),
                                  jnp.asarray(be), leaf_capacity=M, k=k)
    np.testing.assert_array_equal(_bits(wd.numpy()), _bits(jd))
    np.testing.assert_array_equal(we.numpy(), np.asarray(je))
    for runs, slices in ((1, 1), (8, 1), (8, 8)):
        d, e = _model(bd, be, cd, ce, k, M, runs, slices)
        np.testing.assert_array_equal(_bits(d), _bits(wd.numpy()))
        np.testing.assert_array_equal(e, we.numpy())


@pytest.mark.parametrize("k", [1, 10, 2000, 5000, 20000])
def test_no_candidates_leave_the_buffer(k):
    rng = np.random.default_rng(k)
    bd, be = _buffer(rng, 2, k, "ties")
    cd = np.zeros((2, 0), np.float32)
    d, e = _model(bd, be, cd, np.zeros((2, 0), np.int32), k, 1, 8, 8)
    np.testing.assert_array_equal(_bits(d), _bits(bd))
    np.testing.assert_array_equal(e, be)


@pytest.mark.parametrize("k,n", [(1, 7), (3, 40), (10, 64), (10, 200),
                                 (40, 100)])
def test_fold_is_the_rank_rule_at_small_unions(k, n):
    """Against `_rank_select` over the union [buffer, candidates], with
    -0.0 and +0.0 among both: entries equal, distances equal as floats;
    and against the port's stable-sort fold bit for bit."""
    rng = np.random.default_rng(n)
    Q = 3
    bd, be = _buffer(rng, Q, k, "ties")
    cd = _candidates(rng, bd, n, "duplicated")
    bd[bd == 0] = rng.choice(np.float32([0.0, -0.0]), int((bd == 0).sum()))
    cd[cd == 0] = rng.choice(np.float32([0.0, -0.0]), int((cd == 0).sum()))
    bd[0] = BIG                                    # an empty buffer too
    be[0] = 0
    ce = (np.arange(n, dtype=np.int32)[None] + 1000 * np.arange(Q)[:, None]
          ).astype(np.int32)
    alld = torch.cat([torch.from_numpy(bd), torch.from_numpy(cd)], 1)
    alle = torch.cat([torch.from_numpy(be), torch.from_numpy(ce)], 1)
    sd, pos = torch.sort(alld, dim=1, stable=True)
    sd, se = sd[:, :k].numpy(), torch.gather(alle, 1, pos[:, :k]).numpy()
    for runs, slices, M in ((1, 1, 1), (8, 1, 4), (8, 8, 4), (4, 8, 5)):
        d, e = _model(bd, be, cd, ce, k, M, runs, slices)
        np.testing.assert_array_equal(_bits(d), _bits(sd))
        np.testing.assert_array_equal(e, se)
        for i in range(Q):
            rd, re_ = _rank_select(jnp.asarray(alld[i:i + 1].numpy()),
                                   jnp.asarray(alle[i:i + 1].numpy()), k)
            np.testing.assert_array_equal(e[i], np.asarray(re_)[0])
            np.testing.assert_array_equal(d[i], np.asarray(rd)[0])


def test_ties_at_the_kth_value_go_to_the_lower_union_index():
    """Every candidate equal to the k-th best passes no more than the
    room below it allows, lowest union index first, from any run."""
    k, M = 10, 4
    bd = np.float32([[1, 1, 2, 2, 2, 3, 3, 3, 3, 5]])
    be = np.arange(10, dtype=np.int32)[None] + 100
    cd = np.float32([[3] * 32 + [4] * 8 + [2] * 24])
    ce = np.arange(64, dtype=np.int32)[None]
    want_d = np.float32([[1, 1, 2, 2, 2] + [2] * 5])
    want_e = np.int32([[100, 101, 102, 103, 104, 40, 41, 42, 43, 44]])
    for runs, slices in ((1, 1), (8, 8), (2, 3)):
        d, e = _model(bd, be, cd, ce, k, M, runs, slices)
        np.testing.assert_array_equal(_bits(d), _bits(want_d))
        np.testing.assert_array_equal(e, want_e)
