"""The whole refinement of a search at once, against the loop of rounds.

`refine_search` runs each query's rounds until its own stop; the search
of repro runs one global loop until no query is live.  Held here on the
CPU, where the wrapper runs `ref.refine_search_ref`:

* its buffer is bitwise the buffer of the global loop over
  `refine_topk_ref`, written out below, and of each query's own loop
  (side by side, so that the plain version's sums see the same shapes),
  on an index whose queries stop at very different rounds;
* each query's own round count is the count repro's `search_plan_impl`
  (ref backend) returns for that query searched alone, and their maximum
  is repro's count for the batch;
* the loop folded as the kernel folds (`ref.select_merge_fold`: a
  cluster's runs, the buffer whole or in slices) has the global loop's
  bits, on this index and on one that stores each walk three times;
* at k near the collection's size the port's search answers repro's
  ids (but where two distances lie within 1e-5 relative), and each
  query runs repro's rounds;
* the wrapper raises on shapes, dtypes and devices its kernel does not
  take.  The CUDA kernel is held against the same plain version on the
  card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import FreshIndex as JFreshIndex
from repro.api import IndexConfig as JIndexConfig
from repro.core.search import search_plan
from repro_torch import convert
from repro_torch.api import FreshIndex, IndexConfig
from repro_torch.core import search
from repro_torch.data.synthetic import query_workload, random_walk
from repro_torch.kernels import ref, refine, refine_search

torch.set_num_threads(2)

M, K = 8, 8                     # small leaves: 250 of them, up to 32 rounds


@pytest.fixture(scope="module")
def walks():
    return random_walk(2000, 256, seed=41)


@pytest.fixture(scope="module")
def queries(walks):
    """Queries from easy to hard: collection series stop within a round or
    two at k = 1, fresh walks run far longer."""
    return np.concatenate([
        walks[[5, 700, 1500]],
        query_workload(walks, 3, noise_sigma=0.3, seed=43),
        query_workload(walks, 3, seed=44, from_collection=False)])


@pytest.fixture(scope="module")
def indexes(walks):
    return {dtype: JFreshIndex.build(
        walks, JIndexConfig(leaf_capacity=M, dtype=dtype, backend="ref")).index
        for dtype in ("float32", "bfloat16")}


def _queue(jidx, queries, K=K):
    """The port's index and the refinement's inputs, as the search makes
    them."""
    idx = convert.flat_index_from_numpy(
        {f: np.asarray(getattr(jidx, f)) for f in jidx._fields}, "cpu")
    q, q_paa = search.prepare_queries(torch.from_numpy(queries), True,
                                      idx.paa.shape[1])
    q_sq = (q * q).sum(dim=-1)
    lb = search.leaf_lower_bounds(idx, q_paa, idx.series.shape[1])
    order, sorted_lb = search._pq_order(
        lb, K, search._rounds_cap(idx.n_leaves, K))
    return idx, q, q_sq, order, sorted_lb


def _global_loop(q, q_sq, idx, order, sorted_lb, k, K=K):
    """The search's loop of rounds as repro's while_loop runs it: every
    query takes each round while any query is live.  Also returns each
    queue slot's alive flag, (Q, cols) bool."""
    Q = q.shape[0]
    bsf_d = torch.full((Q, k), ref.BIG)
    bsf_e = torch.zeros((Q, k), dtype=torch.int32)
    taken = torch.zeros(order.shape, dtype=torch.bool)
    cursor = 0
    while cursor < order.shape[1] and bool(
            (sorted_lb[:, cursor] < bsf_d[:, -1]).any()):
        alive = sorted_lb[:, cursor:cursor + K] < bsf_d[:, -1:]
        taken[:, cursor:cursor + K] = alive
        bsf_d, bsf_e = ref.refine_topk_ref(
            q, q_sq, idx.series, idx.sq_norms, order[:, cursor:cursor + K],
            alive, bsf_d, bsf_e, leaf_capacity=idx.leaf_capacity, k=k)
        cursor += K
    return bsf_d, bsf_e, cursor // K, taken


def _own_loops(q, q_sq, idx, order, sorted_lb, k):
    """Each query's own loop, side by side: a query stops for good at the
    first round whose first slot is dead, and takes no slot after."""
    Q = q.shape[0]
    bsf_d = torch.full((Q, k), ref.BIG)
    bsf_e = torch.zeros((Q, k), dtype=torch.int32)
    done = torch.zeros(Q, dtype=torch.bool)
    rounds = torch.zeros(Q, dtype=torch.int32)
    for cursor in range(0, order.shape[1], K):
        done |= ~(sorted_lb[:, cursor] < bsf_d[:, -1])
        if bool(done.all()):
            break
        alive = (sorted_lb[:, cursor:cursor + K] < bsf_d[:, -1:]) & ~done[
            :, None]
        bsf_d, bsf_e = ref.refine_topk_ref(
            q, q_sq, idx.series, idx.sq_norms, order[:, cursor:cursor + K],
            alive, bsf_d, bsf_e, leaf_capacity=M, k=k)
        rounds += (~done).to(torch.int32)
    return bsf_d, bsf_e, rounds


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 10])
def test_per_query_loops_equal_the_global_loop_bit_for_bit(
        indexes, queries, dtype, k):
    idx, q, q_sq, order, sorted_lb = _queue(indexes[dtype], queries)
    args = (q, q_sq, idx.series, idx.sq_norms, order, sorted_lb)
    alive = torch.zeros(q.shape[0], dtype=torch.int32)
    d, e, rounds = ref.refine_search_ref(*args, leaf_capacity=M, k=k,
                                         round_leaves=K, alive_out=alive)
    gd, ge, grounds, _ = _global_loop(q, q_sq, idx, order, sorted_lb, k)
    assert torch.equal(d, gd) and torch.equal(e, ge)
    assert int(rounds.max()) == grounds
    # the queries stop at very different rounds
    assert int(rounds.max()) >= 2 * int(rounds.min()) + 6
    assert len(set(rounds.tolist())) >= 5
    assert bool((alive >= rounds).all()) and bool((alive <= K * rounds).all())
    od, oe, orounds = _own_loops(q, q_sq, idx, order, sorted_lb, k)
    assert torch.equal(od, d) and torch.equal(oe, e)
    assert torch.equal(orounds, rounds)



@pytest.mark.parametrize("k", [1, 10])
def test_alive_slots_are_a_prefix_of_each_queue(indexes, queries, k):
    """A query's alive slots are the first `alive_out` entries of its
    queue (it ascends, the k-th best never grows): the distinct leaves
    that a batch reads follow from the counts alone."""
    idx, q, q_sq, order, sorted_lb = _queue(indexes["float32"], queries)
    alive = torch.zeros(q.shape[0], dtype=torch.int32)
    refine_search.refine_search(q, q_sq, idx.series, idx.sq_norms, order,
                                sorted_lb, leaf_capacity=M, k=k,
                                round_leaves=K, alive_out=alive)
    *_, taken = _global_loop(q, q_sq, idx, order, sorted_lb, k)
    cols = torch.arange(order.shape[1])
    assert torch.equal(taken, cols < alive[:, None].long())
    assert 0 < int(alive.min()) < int(alive.max()) < order.shape[1]


@pytest.mark.parametrize("k", [1, 10])
def test_more_slots_a_round_than_threads_a_block(walks, queries, k):
    """K = 260 leaves a round, above the card's 256 threads a block, over
    leaves of 2 series (1000 leaves, 4 rounds): the global loop's bits."""
    jidx = JFreshIndex.build(walks, JIndexConfig(leaf_capacity=2,
                                                 backend="ref")).index
    big = 260
    idx, q, q_sq, order, sorted_lb = _queue(jidx, queries, K=big)
    d, e, rounds = refine_search.refine_search(
        q, q_sq, idx.series, idx.sq_norms, order, sorted_lb, leaf_capacity=2,
        k=k, round_leaves=big)
    gd, ge, grounds, _ = _global_loop(q, q_sq, idx, order, sorted_lb, k,
                                      K=big)
    assert torch.equal(d, gd) and torch.equal(e, ge)
    assert int(rounds.max()) == grounds >= 2

@pytest.mark.parametrize("k", [1, 10])
def test_own_rounds_are_repro_rounds_of_the_query_alone(indexes, queries, k):
    jidx = indexes["float32"]
    idx, q, q_sq, order, sorted_lb = _queue(jidx, queries)
    d, e, rounds = refine_search.refine_search(
        q, q_sq, idx.series, idx.sq_norms, order, sorted_lb, leaf_capacity=M,
        k=k, round_leaves=K)
    alone = [int(search_plan(jidx, jnp.asarray(queries[i:i + 1]), k=k,
                             round_leaves=K, backend="ref")[2])
             for i in range(len(queries))]
    assert rounds.tolist() == alone
    _, _, batch = search_plan(jidx, jnp.asarray(queries), k=k,
                              round_leaves=K, backend="ref")
    assert int(rounds.max()) == int(batch)
    _, _, port = search.search_plan_impl(idx, torch.from_numpy(queries), k=k,
                                         round_leaves=K)
    assert port == int(batch)


@pytest.mark.parametrize("k", [1, 10])
def test_estimated_work_bounds_the_alive_slots(indexes, queries, k):
    """The card's schedule (heaviest first) rests on an overestimate: a
    query's alive slots never exceed its estimated leaves plus the K of
    its first round; with k above the first round's rows it is every
    leaf."""
    idx, q, q_sq, order, sorted_lb = _queue(indexes["float32"], queries)
    args = (q, q_sq, idx.series, idx.sq_norms, order, sorted_lb)
    alive = torch.zeros(q.shape[0], dtype=torch.int32)
    refine_search.refine_search(*args, leaf_capacity=M, k=k, round_leaves=K,
                         alive_out=alive)
    work = refine_search.estimated_work(*args, M, k, K)
    assert work.shape == alive.shape
    assert bool((alive <= work + K).all())
    assert bool((work <= order.shape[1]).all())
    assert bool((refine_search.estimated_work(*args, M, K * M + 1, K)
                 == order.shape[1]).all())


def _args():
    return dict(q=torch.zeros(2, 64), q_sq=torch.zeros(2),
                series=torch.zeros(4 * 8, 64), sq_norms=torch.zeros(32),
                order=torch.zeros(2, 6, dtype=torch.int32),
                sorted_lb=torch.full((2, 6), 1e30))


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    kw = dict(leaf_capacity=8, k=5, round_leaves=3)
    d, e, r = refine_search.refine_search(**_args(), **kw)
    assert d.shape == (2, 5) and r.tolist() == [0, 0]
    for name, bad in (("order", torch.zeros(2, 6, dtype=torch.int64)),
                      ("order", torch.zeros(2, 5, dtype=torch.int32)),
                      ("sorted_lb", torch.zeros(2, 6, dtype=torch.float64)),
                      ("sorted_lb", torch.zeros(3, 6)),
                      ("series", torch.zeros(30, 64)),
                      ("q_sq", torch.zeros(3)),
                      ("sq_norms", torch.zeros(31)),
                      ("q", torch.zeros(64, 2).t())):
        with pytest.raises(ValueError):
            refine_search.refine_search(**{**_args(), name: bad}, **kw)
    with pytest.raises(TypeError):
        refine_search.refine_search(
            **{**_args(), "series": torch.zeros(32, 64).double()}, **kw)
    for bad_kw in (dict(kw, k=0), dict(kw, round_leaves=0),
                   dict(kw, leaf_capacity=0)):
        with pytest.raises(ValueError):
            refine_search.refine_search(**_args(), **bad_kw)
    with pytest.raises(ValueError):
        refine_search.refine_search(**_args(), **kw,
                             alive_out=torch.zeros(2, dtype=torch.int64))
    meta = {n: t.to("meta") for n, t in _args().items()}
    with pytest.raises(RuntimeError, match="no refine_search kernel"):
        refine_search.refine_search(**meta, **kw)
    with pytest.raises(ValueError, match="share a device"):
        refine_search.refine_search(
            **{**_args(), "sorted_lb": meta["sorted_lb"]}, **kw)


def test_cpu_tensors_run_the_plain_version_and_count_nothing(indexes,
                                                             queries):
    idx, q, q_sq, order, sorted_lb = _queue(indexes["float32"], queries)
    args = (q, q_sq, idx.series, idx.sq_norms, order, sorted_lb)
    before = (refine_search.launches, refine.launches)
    alive = torch.zeros(q.shape[0], dtype=torch.int32)
    got = refine_search.refine_search(*args, leaf_capacity=M, k=10,
                                      round_leaves=K, alive_out=alive)
    want_alive = torch.zeros_like(alive)
    want = ref.refine_search_ref(*args, leaf_capacity=M, k=10,
                                 round_leaves=K, alive_out=want_alive)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(alive, want_alive)
    assert (refine_search.launches, refine.launches) == before


def _fold_loop(q, q_sq, idx, order, sorted_lb, k, runs, slices, K=K):
    """The global loop of rounds with refine_search's fold
    (`ref.select_merge_fold`, the kernel's cut, runs and slices) in place
    of `refine_topk_ref`'s: the candidates are refine_topk_ref's own
    distances, in union order."""
    Q, M = q.shape[0], idx.leaf_capacity
    bsf_d = torch.full((Q, k), ref.BIG)
    bsf_e = torch.zeros((Q, k), dtype=torch.int32)
    rounds = torch.zeros(Q, dtype=torch.int32)
    cursor = 0
    while cursor < order.shape[1] and bool(
            (sorted_lb[:, cursor] < bsf_d[:, -1]).any()):
        rounds += (sorted_lb[:, cursor] < bsf_d[:, -1]).to(torch.int32)
        alive = sorted_lb[:, cursor:cursor + K] < bsf_d[:, -1:]
        entry = (order[:, cursor:cursor + K].long()[..., None] * M
                 + torch.arange(M)).reshape(Q, -1)
        dots = torch.einsum("qnl,ql->qn", idx.series[entry].float(), q)
        d2 = (q_sq[:, None] + idx.sq_norms[entry] - 2.0 * dots).clamp_min(0)
        d2 = torch.where(alive.repeat_interleave(M, dim=1), d2,
                         torch.full_like(d2, ref.BIG))
        bsf_d, bsf_e = ref.select_merge_fold(
            bsf_d, bsf_e, d2, entry.to(torch.int32), k, leaf_capacity=M,
            runs=runs, slices=slices)
        cursor += K
    return bsf_d, bsf_e, rounds


@pytest.mark.parametrize("k", [10, 500])
@pytest.mark.parametrize("layout", [(8, 1), (8, 8)])
@pytest.mark.parametrize("stored", [1, 3])
def test_the_kernels_fold_gives_the_global_loops_bits(walks, queries, k,
                                                      layout, stored):
    """The loop folded as the kernel folds (a cluster's 8 runs, the
    buffer whole or in 8 slices) equals refine_search_ref bit for bit,
    also on an index storing each walk three times (every distance a
    three-way tie)."""
    runs, slices = layout
    coll = np.concatenate([walks[:700]] * 3) if stored == 3 else walks
    jidx = JFreshIndex.build(coll, JIndexConfig(leaf_capacity=M,
                                                backend="ref")).index
    idx, q, q_sq, order, sorted_lb = _queue(jidx, queries)
    d, e, rounds = ref.refine_search_ref(
        q, q_sq, idx.series, idx.sq_norms, order, sorted_lb,
        leaf_capacity=M, k=k, round_leaves=K)
    fd, fe, frounds = _fold_loop(q, q_sq, idx, order, sorted_lb, k, runs,
                                 slices)
    assert torch.equal(fd.view(torch.int32), d.view(torch.int32))
    assert torch.equal(fe, e) and torch.equal(frounds, rounds)


@pytest.mark.parametrize("k", [500, 1999])
def test_search_at_large_k_answers_repros_ids_and_rounds(walks, queries,
                                                         indexes, k):
    """FreshIndex.search at k near the collection's size: repro's ids,
    and each query's rounds those of repro's search_plan (ref backend)
    for the query alone."""
    ix = FreshIndex.build(walks, IndexConfig(leaf_capacity=M), device="cpu")
    jx = JFreshIndex.build(walks, JIndexConfig(leaf_capacity=M,
                                               backend="ref"))
    d, i = (a.numpy() for a in ix.search(queries, k=k, round_leaves=K))
    dj, ij = (np.asarray(a) for a in jx.search(jnp.asarray(queries), k=k,
                                               round_leaves=K))
    np.testing.assert_allclose(d, dj, rtol=1e-5, atol=1e-5)
    # ids equal but where two of repro's distances lie within 1e-5
    # relative (each package's sums round apart): the port's id is one of
    # those at its distance
    for r, s in zip(*np.nonzero(i != ij)):
        near = np.abs(dj[r] - d[r, s]) <= 1e-5 * d[r, s]
        assert near.sum() >= 2 and i[r, s] in ij[r][near]
    idx, q, q_sq, order, sorted_lb = _queue(indexes["float32"], queries)
    _, _, rounds = refine_search.refine_search(
        q, q_sq, idx.series, idx.sq_norms, order, sorted_lb, leaf_capacity=M,
        k=k, round_leaves=K)
    alone = [int(search_plan(indexes["float32"], jnp.asarray(queries[j:j + 1]),
                             k=k, round_leaves=K, backend="ref")[2])
             for j in range(len(queries))]
    assert rounds.tolist() == alone
