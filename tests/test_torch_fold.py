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

Beside it, refine_topk's general route (csrc/refine.cu, refine_general):
one fold of a round over all its candidates held to the round folded
slot by slot, its selection of the first k (warps, then the kept) held
to a sort, and its sums of a row by groups of lanes held to the warp's
xor-shuffle order bit for bit.
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


@pytest.mark.parametrize("kind", ["empty", "ties"])
@pytest.mark.parametrize("k,K,M", [(10, 8, 64), (10, 264, 16), (16000, 8, 64),
                                   (16000, 16, 256)])
def test_one_fold_of_a_round_is_the_round_folded_slot_by_slot(k, K, M, kind):
    """refine_topk's general route folds a round once, over all K * M
    candidates of its alive slots (one CTA: one run, the buffer whole),
    where it folded them slot by slot: the same buffer bit for bit, ties
    included (duplicated rows, candidates equal to buffer entries and to
    the k-th value), at k 10 and 16,000, half the slots dead (their
    candidates never pass, as their distance past every k-th best
    models).  Held to the loop of one-slot rounds of the port's
    `refine_topk_ref` and to its one round over all the slots."""
    rng = np.random.default_rng(k + K + M)
    Q = 2
    bd, be = _buffer(rng, Q, k, kind)
    cd = _candidates(rng, bd, K * M, "duplicated")
    args, ce = _fold_inputs(cd, M)
    alive = rng.random((Q, K)) < 0.5
    alive[:, 0] = True
    q, q_sq, series, norms, leaf_ids, _ = map(torch.from_numpy, args)
    alive_t = torch.from_numpy(alive)
    d, e = torch.from_numpy(bd), torch.from_numpy(be)
    for j in range(K):
        d, e = ref.refine_topk_ref(q, q_sq, series, norms,
                                   leaf_ids[:, j:j + 1].contiguous(),
                                   alive_t[:, j:j + 1].contiguous(), d, e,
                                   leaf_capacity=M, k=k)
    once_d, once_e = ref.refine_topk_ref(q, q_sq, series, norms, leaf_ids,
                                         alive_t, torch.from_numpy(bd),
                                         torch.from_numpy(be),
                                         leaf_capacity=M, k=k)
    live = np.where(np.repeat(alive, M, axis=1), cd, np.float32(np.inf))
    md, me = _model(bd, be, live, ce, k, M, 1, 1)
    for got_d, got_e in ((once_d.numpy(), once_e.numpy()), (md, me)):
        np.testing.assert_array_equal(_bits(got_d), _bits(d.numpy()))
        np.testing.assert_array_equal(got_e, e.numpy())
    assert (d.numpy() != bd).any()            # the round changed the buffer


def _xor_tree(v):
    """A warp's xor-shuffle sum of 32 lanes' float32 values at lane 0
    (distances 16, 8, 4, 2, 1, each lane adding its partner's)."""
    v = v.copy()
    off = 16
    while off:
        v = (v + v[np.arange(32) ^ off]).astype(np.float32)
        off //= 2
    return v[0]


@pytest.mark.parametrize("G", [1, 4, 8, 32])
@pytest.mark.parametrize("pieces", [1, 25, 32, 235, 1001])
def test_a_group_of_lanes_sums_a_row_as_the_warp_does(G, pieces):
    """refine_general's group_d2 (csrc/refine.cu) sums a staged row with G
    lanes where rows_d2 takes a warp: the warp's lane s is slot s of lane
    s % G, each slot summing its pieces s, s + 32, ... in order, a lane
    adding its own slots at the xor distances 16 .. G, then the group
    shuffling at G / 2 .. 1.  Its lane 0 holds the warp's lane-0 sum bit
    for bit (float32 steps, the pieces' terms at random scales)."""
    rng = np.random.default_rng(G * 10007 + pieces)
    terms = (rng.standard_normal(pieces)
             * 10.0 ** rng.integers(-3, 4, pieces)).astype(np.float32)
    slot = np.zeros(32, dtype=np.float32)
    for p in range(pieces):                   # each slot's pieces in order
        slot[p % 32] = np.float32(slot[p % 32] + terms[p])
    want = _xor_tree(slot)
    lanes = np.stack([slot[g::G] for g in range(G)])   # (G, 32 / G) slots
    h = 32 // G // 2
    while h:                                  # a lane's own slots
        lanes[:, :h] = (lanes[:, :h] + lanes[:, h:2 * h]).astype(np.float32)
        h //= 2
    v = lanes[:, 0].copy()
    off = G // 2
    while off:                                # the group's shuffles
        v = (v + v[np.arange(G) ^ off]).astype(np.float32)
        off //= 2
    assert np.float32(v[0]).tobytes() == np.float32(want).tobytes()


@pytest.mark.parametrize("n,k", [(0, 10), (7, 10), (320, 10), (512, 10),
                                 (512, 32), (300, 1), (64, 32)])
def test_warps_keep_their_first_k_then_rank_the_kept(n, k):
    """refine_general's select_keys for k <= 32 and n <= 512 keys: each of
    8 warps ranks its 64 keys (a lane's keys i and i + 256) among
    themselves and keeps those of rank below k; the kept, ranked among
    themselves, give the first min(n, k) of all n in order (keys distinct,
    as (distance, union index) keys are; clustered so that a warp's kept
    crowd out another's)."""
    rng = np.random.default_rng(n * 31 + k)
    keys = rng.choice(1 << 20, size=n, replace=False).astype(np.uint64)
    keys[: n // 3] = np.sort(keys[: n // 3])        # one run low, in order
    pad = np.full(512, np.iinfo(np.uint64).max, dtype=np.uint64)
    pad[:n] = keys
    kept = []
    for w in range(8):
        mine = np.concatenate([pad[32 * w:32 * w + 32],
                               pad[256 + 32 * w:256 + 32 * w + 32]])
        rank = (mine[None, :] < mine[:, None]).sum(1)
        kept += [x for x, r in zip(mine, rank)
                 if r < k and x != np.iinfo(np.uint64).max]
    kept = np.array(kept, dtype=np.uint64)
    out = np.empty(min(n, k), dtype=np.uint64)
    for x in kept:
        r = int((kept < x).sum())
        if r < k:
            out[r] = x
    np.testing.assert_array_equal(out, np.sort(keys)[:k])
