"""Approximate search and its calibration in the port, against repro.

The same numpy inputs from a seed go through repro (backend "ref") and
the port on the CPU, at test_quality.py's size (L 64, 256 core rows, 32
delta rows, leaves of 8):

* approximate search parity: every stop rule (eps 0.05 / 0.25 / 0.5,
  max_leaves 1 / 3 / 8, eps 0.25 with max_leaves 4), pq_budget 5 and
  max_rounds 2, at k 1 / 5 / 10, three bounds and two storage types: the
  port's ids equal repro's, distances at rtol 1e-5, batch rounds equal;
  and through both facades with a pending delta and tombstones;
* exact mode is the port's search as it was before approximate search
  (the same function with default knobs), byte for byte;
* the refinement under a scale inv_eps != 1 gives the global loop's
  buffer bit for bit and, per query, repro's rounds for that query alone;
* calibration: holdout_queries, oracle_topk (also streamed in small row
  blocks), pq_leaf_candidates and recall_at_k match repro's; each
  setting's ids and visited leaves equal repro's, and calibrate()'s
  fitted visited_frac and met too; where visited_frac breaks the tie,
  the rule and its recall (between settings of equal cost, latency,
  which is host noise, picks the rule);
* repro's invariants: results inside the leaf candidates, true distances,
  calibrated recall on the holdout, resolve_stop_rule's errors,
  freshness after add; the tables cross checkpoints both ways, and a
  config's pq_budget crosses with them.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import FreshIndex as JFreshIndex
from repro.api import IndexConfig as JIndexConfig
from repro.core.search import search_plan as jsearch_plan
from repro.quality.stop_rules import StopRule as JStopRule
from repro_torch import convert
from repro_torch.api import FreshIndex, IndexConfig
from repro_torch.core import isax, search
from repro_torch.core.search import merge_delta_topk, search_bruteforce
from repro_torch.data.synthetic import query_workload, random_walk
from repro_torch.kernels import ref
from repro_torch.quality import calibrate as cal
from repro_torch.quality.stop_rules import EXACT, StopRule

# the module, which repro.quality's namesake function shadows
jcal = importlib.import_module("repro.quality.calibrate")

torch.set_num_threads(2)

L, N_CORE, N_DELTA, M, K = 64, 256, 32, 8, 8
TARGET = 0.95
DELETED = [3, 17, 120, 256, 270]            # core ids and delta ids
# the plan knobs of every setting held to repro
SETTINGS = [dict(stop_eps=0.05), dict(stop_eps=0.25), dict(stop_eps=0.5),
            dict(stop_leaves=1), dict(stop_leaves=3), dict(stop_leaves=8),
            dict(stop_eps=0.25, stop_leaves=4), dict(pq_budget=5),
            dict(max_rounds=2)]


@pytest.fixture(scope="module")
def data():
    walks = random_walk(N_CORE, L, seed=41)
    extra = random_walk(N_DELTA, L, seed=42)
    both = np.concatenate([walks, extra])
    # near duplicates stop within a round; noisier ones and fresh walks
    # run long enough for a stop rule to cut them
    queries = np.concatenate([
        query_workload(both, 4, noise_sigma=0.05, seed=43),
        query_workload(both, 4, noise_sigma=0.5, seed=44),
        query_workload(both, 4, seed=45, from_collection=False)])
    return walks, extra, queries


def _facade_kw(setting: dict) -> dict:
    """A plan setting as FreshIndex.search takes it."""
    kw = {"max_leaves" if k == "stop_leaves" else k: v
          for k, v in setting.items()}
    if "stop_eps" in kw or "max_leaves" in kw:
        kw["mode"] = "approx"
    return kw


def _pair(data, dtype="float32", lifecycle=True):
    """repro's FreshIndex and the port's over the same rows: a pending
    delta, tombstones in core and delta (and one update) when
    `lifecycle`."""
    walks, extra, _ = data
    jx = JFreshIndex.build(walks, JIndexConfig(leaf_capacity=M, dtype=dtype,
                                               backend="ref"))
    ix = FreshIndex.build(walks, IndexConfig(leaf_capacity=M, dtype=dtype),
                          device="cpu")
    if lifecycle:
        for x in (jx, ix):
            x.add(extra)
            assert x.delete(DELETED) == len(DELETED)
            x.update(40, random_walk(1, L, seed=46)[0])
    return jx, ix


def _same_index(data, tmp_path):
    """repro's lifecycle index (`_pair`) and the port's load of its
    checkpoint: the same stored bits, delta, tombstones and aliases."""
    jx, _ = _pair(data)
    jx.save(str(tmp_path / "same"))
    return jx, FreshIndex.load(str(tmp_path / "same"), device="cpu")


# --------------------------------------------------------------------- #
# approximate search parity
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bound", ["prefix", "symbox", "paabox"])
def test_approx_plan_matches_repro_on_the_same_index(data, bound, dtype):
    walks, _, queries = data
    jidx = JFreshIndex.build(walks, JIndexConfig(
        leaf_capacity=M, bound=bound, dtype=dtype, backend="ref")).index
    tidx = convert.flat_index_from_numpy(
        {f: np.asarray(getattr(jidx, f)) for f in jidx._fields}, "cpu")
    q = torch.from_numpy(queries)
    cut = 0
    for k in (1, 5, 10):
        _, i_exact, r_exact = search.search_plan_impl(tidx, q, k=k)
        for s in SETTINGS:
            dj, ij, rj = jsearch_plan(jidx, jnp.asarray(queries), k=k,
                                      round_leaves=K, backend="ref", **s)
            dt, it, rt = search.search_plan_impl(tidx, q, k=k,
                                                 round_leaves=K, **s)
            what = f"k={k} {s}"
            np.testing.assert_array_equal(it.numpy(), np.asarray(ij),
                                          err_msg=what)
            np.testing.assert_allclose(dt.numpy(), np.asarray(dj),
                                       rtol=1e-5, err_msg=what)
            assert rt == int(rj), what
            assert rt <= r_exact, what
            cut += not torch.equal(it, i_exact)
    assert cut >= len(SETTINGS), "the settings changed too few answers"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_approx_search_with_delta_and_tombstones_matches_repro(data, dtype):
    _, _, queries = data
    jx, ix = _pair(data, dtype)
    jcore = jx.search_view()[0]
    q = torch.from_numpy(queries)
    for k in (1, 5, 10):
        for s in SETTINGS:
            what = f"k={k} {s}"
            dj, ij = jx.search(jnp.asarray(queries), k=k, **_facade_kw(s))
            d, i = ix.search(queries, k=k, **_facade_kw(s))
            np.testing.assert_array_equal(i.numpy(), np.asarray(ij),
                                          err_msg=what)
            np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-5,
                                       atol=1e-5, err_msg=what)
            assert not set(i.flatten().tolist()) & set(DELETED)
            # repro's rounds: its core plan as its search ran it (the
            # same static knobs, so the compiled program is reused)
            knobs = dict(max_rounds=None, pq_budget=None, stop_eps=0.0,
                         stop_leaves=None) | s
            _, _, rj = jsearch_plan(jcore, jnp.asarray(queries), k=k,
                                    round_leaves=K, znorm=True,
                                    backend="ref", dma_depth=1, block_q=1,
                                    **knobs)
            assert ix._plan(q, k, round_leaves=K, **s)[2] == int(rj), what


# --------------------------------------------------------------------- #
# exact mode: the port's search as it was, byte for byte
# --------------------------------------------------------------------- #
def _search_before(ix: FreshIndex, queries, k: int):
    """FreshIndex.search before approximate search: run_search at
    round_leaves 8 over the masked core, the delta rows merged in."""
    q = torch.as_tensor(queries)
    core, delta, alive, id0 = ix.search_view()
    d, i = search.run_search(core, q, k=k, round_leaves=8,
                             znorm=ix.config.znorm)
    if delta is not None:
        md, mi = merge_delta_topk(
            ix.delta_rows, isax.znormalize(q), d[:, None] if k == 1 else d,
            i[:, None] if k == 1 else i, alive, k=k, n_base=id0,
            znorm=False)
        d, i = search.squeeze_k(md, mi, k)
    return d, ix._remap_ids(i)


@pytest.mark.parametrize("lifecycle", [False, True])
@pytest.mark.parametrize("k", [1, 5, 10])
def test_exact_mode_is_the_search_before_bit_for_bit(data, k, lifecycle):
    _, _, queries = data
    _, ix = _pair(data, lifecycle=lifecycle)
    d0, i0 = _search_before(ix, queries, k)
    d, i, _ = ix._plan(torch.from_numpy(queries), k, round_leaves=8,
                       **EXACT.lower())
    d, i = search.squeeze_k(d, ix._remap_ids(i), k)
    for d, i in ((d, i), ix.search(queries, k),
                 ix.search(queries, k, mode="exact"),
                 ix.search(queries, k, mode="approx", stop_eps=0.0),
                 ix.search(queries, k, round_leaves=8, pq_budget=None)):
        assert d.numpy().tobytes() == d0.numpy().tobytes()
        assert i.numpy().tobytes() == i0.numpy().tobytes()


# --------------------------------------------------------------------- #
# the refinement under the (1 + eps) stop
# --------------------------------------------------------------------- #
def _queue(jidx, queries):
    idx = convert.flat_index_from_numpy(
        {f: np.asarray(getattr(jidx, f)) for f in jidx._fields}, "cpu")
    q, q_paa = search.prepare_queries(torch.from_numpy(queries), True,
                                      idx.paa.shape[1])
    lb = search.leaf_lower_bounds(idx, q_paa, idx.series.shape[1])
    order, sorted_lb = search._pq_order(
        lb, K, search._rounds_cap(idx.n_leaves, K))
    return idx, q, (q * q).sum(dim=-1), order, sorted_lb


def _global_loop(q, q_sq, idx, order, sorted_lb, k, inv_eps):
    """repro's while_loop written out: every query takes each round while
    any query's next lower bound is below its k-th best times
    float32(inv_eps)."""
    Q = q.shape[0]
    scale = np.float32(inv_eps)
    bsf_d = torch.full((Q, k), ref.BIG)
    bsf_e = torch.zeros((Q, k), dtype=torch.int32)
    cursor = 0
    while cursor < order.shape[1]:
        bound = torch.from_numpy(bsf_d[:, -1:].numpy() * scale)
        if not bool((sorted_lb[:, cursor:cursor + 1] < bound).any()):
            break
        alive = sorted_lb[:, cursor:cursor + K] < bound
        bsf_d, bsf_e = ref.refine_topk_ref(
            q, q_sq, idx.series, idx.sq_norms, order[:, cursor:cursor + K],
            alive, bsf_d, bsf_e, leaf_capacity=M, k=k)
        cursor += K
    return bsf_d, bsf_e, cursor // K


@pytest.mark.parametrize("eps", [0.25, 1.0])
@pytest.mark.parametrize("k", [1, 10])
def test_refinement_under_eps_is_the_global_loop_and_repros_rounds(
        data, k, eps):
    walks, _, queries = data
    jidx = JFreshIndex.build(walks, JIndexConfig(leaf_capacity=M,
                                                 backend="ref")).index
    idx, q, q_sq, order, sorted_lb = _queue(jidx, queries)
    inv_eps, _ = search._stop_knobs(eps, None, None)
    assert inv_eps == 1.0 / (1.0 + eps) ** 2 != 1.0
    args = (q, q_sq, idx.series, idx.sq_norms, order, sorted_lb)
    d, e, rounds = ref.refine_search_ref(*args, leaf_capacity=M, k=k,
                                         round_leaves=K, inv_eps=inv_eps)
    gd, ge, grounds = _global_loop(q, q_sq, idx, order, sorted_lb, k,
                                   inv_eps)
    assert torch.equal(d, gd) and torch.equal(e, ge)
    assert int(rounds.max()) == grounds
    alone = [int(jsearch_plan(jidx, jnp.asarray(queries[i:i + 1]), k=k,
                              round_leaves=K, backend="ref",
                              stop_eps=eps)[2])
             for i in range(len(queries))]
    assert rounds.tolist() == alone
    exact = ref.refine_search_ref(*args, leaf_capacity=M, k=k,
                                  round_leaves=K)[2]
    assert bool((rounds <= exact).all()) and int(rounds.sum()) < int(
        exact.sum())


# --------------------------------------------------------------------- #
# calibration helpers
# --------------------------------------------------------------------- #
def test_holdout_oracle_candidates_and_recall_match_repro(data, tmp_path):
    jx, ix = _same_index(data, tmp_path)
    hq = cal.holdout_queries(ix, n=24, noise=0.25, seed=5)
    assert hq.tobytes() == jcal.holdout_queries(jx, n=24, noise=0.25,
                                                seed=5).tobytes()
    for k in (1, 5, 10):
        d, i = cal.oracle_topk(ix, hq, k)
        dj, ij = jcal.oracle_topk(jx, hq, k)
        np.testing.assert_array_equal(i, ij)
        np.testing.assert_allclose(d, dj, rtol=1e-5, atol=1e-5)
        # streamed in blocks of 16 core rows: the same answer
        ds, is_ = cal.oracle_topk(ix, hq, k, block_rows=16)
        np.testing.assert_array_equal(is_, i)
        np.testing.assert_allclose(ds, d, rtol=1e-6)
    for n in (4, 8):
        np.testing.assert_array_equal(
            cal.pq_leaf_candidates(ix, hq, n),
            jcal.pq_leaf_candidates(jx, jnp.asarray(hq), n))
    rng = np.random.default_rng(6)
    for _ in range(5):
        a = rng.integers(-1, 40, (6, 10))
        b = rng.integers(-1, 40, (6, 10))
        assert cal.recall_at_k(a, b) == jcal.recall_at_k(a, b)
    assert cal.recall_at_k(np.full((2, 3), -1), np.full((2, 3), -1)) == 1.0


def test_each_setting_and_the_fitted_table_match_repro(data, tmp_path):
    jx, ix = _same_index(data, tmp_path)
    hq = cal.holdout_queries(ix, n=24, noise=0.25, seed=5)
    eps_grid, leaves_grid, targets = (0.0, 0.25, 0.5), (8, 16), (0.9, TARGET)
    rules = [StopRule(eps=e, max_leaves=m) for m in leaves_grid
             for e in eps_grid] + [EXACT]
    kw = dict(ks=(1, 5, 10), targets=targets, queries=hq, eps_grid=eps_grid,
              leaves_grid=leaves_grid, repeat=1)
    table, jtable = ix.calibrate(**kw), jx.calibrate(**kw)
    assert len(table) == len(jtable) == 6
    for k in (1, 5, 10):
        _, oracle = cal.oracle_topk(ix, hq, k)
        rows = []
        for rule in rules:
            ids, visited, _ = cal._run_setting(ix, hq, k, rule, 1)
            jids, jvisited, _ = jcal._run_setting(
                jx, hq, k, JStopRule(rule.eps, rule.max_leaves), None, 1)
            np.testing.assert_array_equal(ids, jids, err_msg=str(rule))
            assert visited == jvisited, rule
            rows.append((rule, cal.recall_at_k(ids, oracle), visited))
        for t in targets:
            e, je = table.lookup(k, t), jtable.lookup(k, t)
            assert (e.visited_frac, e.met) == (je.visited_frac, je.met)
            ok = [r for r in rows if r[1] >= t]
            tied = [r for r in ok if r[2] == min(x[2] for x in ok)]
            # settings of equal cost: latency picks, and with it the rule
            # and its recall
            assert {e.recall, je.recall} <= {r[1] for r in tied}, (k, t)
            if len(tied) == 1:
                assert e.recall == je.recall, (k, t)
                assert e.rule.to_dict() == je.rule.to_dict(), (k, t)
                assert e.rule == tied[0][0]


# --------------------------------------------------------------------- #
# repro's invariants, held on the port
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def calibrated(data):
    _, ix = _pair(data, lifecycle=False)
    ix.add(data[1])
    hq = cal.holdout_queries(ix, n=24, noise=0.25, seed=5)
    table = ix.calibrate(ks=(1, 5, 10), targets=(TARGET,), queries=hq,
                         eps_grid=(0.0, 0.25, 0.5), leaves_grid=(8, 16),
                         repeat=1)
    return ix, hq, table


@pytest.mark.parametrize("k", [1, 5, 10])
def test_calibrated_recall_meets_target(calibrated, k):
    ix, hq, table = calibrated
    assert table.lookup(k, TARGET) is not None
    d, i = ix.search(hq, k=k, mode="approx", recall_target=TARGET)
    _, io = cal.oracle_topk(ix, hq, k)
    assert cal.recall_at_k(i.numpy(), io) >= TARGET
    d = d.numpy()
    if d.ndim == 2:
        assert np.all(np.diff(d, axis=1) >= -1e-5)
    assert np.all(d < 1e15)


def test_approx_distances_are_true_distances(data, calibrated):
    walks, extra, queries = data
    ix, _, _ = calibrated
    raw = torch.from_numpy(np.concatenate([walks, extra]))
    q = torch.from_numpy(queries)
    d, i = ix.search(q, k=10, mode="approx", recall_target=TARGET)
    d_all, i_all = search_bruteforce(raw, q, k=raw.shape[0])
    for r in range(q.shape[0]):
        true = dict(zip(i_all[r].tolist(), d_all[r].tolist()))
        for col in range(10):
            sid = int(i[r, col])
            assert sid in true, f"approx returned unreal id {sid}"
            np.testing.assert_allclose(d[r, col], true[sid], rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.parametrize("m", [4, 8])
def test_approx_results_within_leaf_candidates(data, m):
    _, _, queries = data
    _, ix = _pair(data)
    d, i = ix.search(queries, k=10, mode="approx", max_leaves=m)
    cands = cal.pq_leaf_candidates(ix, queries, m)
    delta_ids = set(range(ix._delta_id0, ix._delta_id0 + ix.n_pending))
    for r in range(queries.shape[0]):
        allowed = set(cands[r].tolist()) | delta_ids | {40}
        got = set(i[r].tolist()) - {-1}
        assert got <= allowed, (m, r, sorted(got - allowed))


def test_stop_rule_resolution_errors(data):
    _, ix = _pair(data)
    with pytest.raises(ValueError, match="exact"):
        ix.resolve_stop_rule("exact", k=10, stop_eps=0.1)
    with pytest.raises(ValueError, match="exact"):
        ix.search(np.zeros((1, L), np.float32), k=10, max_leaves=3)
    with pytest.raises(ValueError, match="calibrat"):
        ix.resolve_stop_rule("approx", k=10)       # no table fitted
    with pytest.raises(ValueError):
        ix.search(np.zeros((1, L), np.float32), k=10, mode="warp")
    assert ix.resolve_stop_rule("exact", k=10) is EXACT
    r = ix.resolve_stop_rule("approx", k=10, stop_eps=0.1, max_leaves=4)
    assert r == StopRule(eps=0.1, max_leaves=4)
    for bad in (dict(eps=-1.0), dict(max_leaves=0), dict(eps=float("nan"))):
        with pytest.raises(ValueError):
            StopRule(**bad)
    with pytest.raises(ValueError):
        search._stop_knobs(-0.1, None, None)
    with pytest.raises(ValueError):
        search._stop_knobs(0.0, 0, None)
    assert search._stop_knobs(0.0, 3, 5) == (1.0, 3)
    assert str(EXACT) == "exact" and str(r) == str(JStopRule(0.1, 4))
    assert StopRule.from_dict(JStopRule(0.25, 8).to_dict()) == StopRule(0.25,
                                                                        8)
    assert EXACT.is_exact and EXACT.lower() == {"stop_eps": 0.0,
                                                "stop_leaves": None}


def test_calibration_crosses_checkpoints_and_tracks_freshness(data,
                                                              tmp_path):
    jx, ix = _pair(data)
    hq = cal.holdout_queries(ix, n=8, seed=9)
    kw = dict(ks=(10,), targets=(TARGET,), queries=hq, eps_grid=(0.0, 0.25),
              leaves_grid=(8,), repeat=1)
    table = ix.calibrate(**kw)
    assert ix.is_calibration_fresh() and ix.stats()["calibrated"]
    fp = cal.index_fingerprint(ix)
    # the port's table: the port reloads it fresh, repro loads it stale
    ix.save(str(tmp_path / "port"))
    out = FreshIndex.load(str(tmp_path / "port"), device="cpu")
    assert out.calibration.to_dict() == table.to_dict()
    assert out.calibration.fingerprint == fp and out.is_calibration_fresh()
    assert out.resolve_stop_rule("approx", k=10, recall_target=TARGET) \
        == table.lookup(10, TARGET).rule
    jout = JFreshIndex.load(str(tmp_path / "port"))
    assert jout.calibration.to_dict() == table.to_dict()
    assert not jout.is_calibration_fresh()
    # repro's table: stale in the port, yet it resolves as in repro
    jtable = jx.calibrate(**kw)
    jx.save(str(tmp_path / "repro"))
    back = FreshIndex.load(str(tmp_path / "repro"), device="cpu")
    assert back.calibration.to_dict() == jtable.to_dict()
    assert not back.is_calibration_fresh() and back.stats()["calibrated"]
    for k, t in ((10, TARGET),):
        rule = back.resolve_stop_rule("approx", k=k, recall_target=t)
        assert rule.to_dict() == jtable.lookup(k, t).rule.to_dict()
        d, i = back.search(hq, k=k, mode="approx", recall_target=t)
        _, ij = jx.search(jnp.asarray(hq), k=k, mode="approx",
                          recall_target=t)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    # mutation makes the table stale (but it still resolves)
    out.add(random_walk(1, L, seed=77))
    assert not out.is_calibration_fresh()
    out.resolve_stop_rule("approx", k=10, recall_target=TARGET)


def test_a_repro_checkpoint_with_a_pq_budget_answers_as_repro(data,
                                                               tmp_path):
    """repro's IndexConfig(pq_budget=3) crosses a checkpoint: the port
    answers it capped, as repro does, not exactly."""
    walks, _, queries = data
    jx = JFreshIndex.build(walks, JIndexConfig(leaf_capacity=8, pq_budget=3,
                                               backend="ref"))
    jx.save(str(tmp_path))
    ix = FreshIndex.load(str(tmp_path), device="cpu")
    assert ix.config.pq_budget == 3 and ix.config.round_leaves is None
    assert ix.search_knobs().pq_budget == 3
    for k in (1, 5, 10):
        d, i = ix.search(queries, k=k)
        dj, ij = jx.search(jnp.asarray(queries), k=k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
        np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-5)
        _, exact = ix.search(queries, k=k, pq_budget=10 ** 6)
        assert not torch.equal(exact, i), "pq_budget=3 cut nothing"


def test_config_validates_the_optional_knobs():
    assert IndexConfig().round_leaves is None
    assert IndexConfig().pq_budget is None
    for bad in (dict(round_leaves=0), dict(pq_budget=0)):
        with pytest.raises(ValueError):
            IndexConfig(**bad)
    cfg = IndexConfig(round_leaves=16, pq_budget=7)
    assert IndexConfig.from_dict(cfg.to_dict()) == cfg
    jd = JIndexConfig(round_leaves=4, pq_budget=9, dma_depth=2).to_dict()
    assert IndexConfig.from_dict(jd) == IndexConfig(round_leaves=4,
                                                    pq_budget=9)
