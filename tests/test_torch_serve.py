"""The port's serving layer (repro_torch.serve) against repro's, on the
CPU: every local case of tests/test_serve.py and the engine cases of
tests/test_maintenance.py, run on the port's engine.

Parity: the port's index is loaded from repro's fresh-index-v1
checkpoint, so the stored bits agree; the port's engine rows are held
bit for bit to the port's facade (on the CPU a plan calls exactly what
`FreshIndex.search` calls), and their ids to repro's engine on the same
numpy queries.  The micro-batcher, the result cache's fingerprint and
the plan key are held to repro's on the same inputs.  Every threaded
wait is bounded (result(timeout=...), joins with a timeout)."""

import dataclasses
import os
import threading
import time

import numpy as np
import pytest
import torch

from repro.api import FreshIndex as JFreshIndex
from repro.api import IndexConfig as JIndexConfig
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import MicroBatcher as JMicroBatcher
from repro.serve import Pending as JPending
from repro.serve import bucket_for as jbucket_for
from repro.serve import query_fingerprint as jfingerprint
from repro.serve import shape_buckets as jshape_buckets
from repro_torch.api import FreshIndex, IndexConfig
from repro_torch.core.refresh import WorkerCrash
from repro_torch.core.search import search_bruteforce
from repro_torch.data.synthetic import query_workload, random_walk
from repro_torch.maintenance import FreshnessClass, MaintenancePolicy
from repro_torch.quality.calibrate import CalibrationTable
from repro_torch.quality.stop_rules import StopRule
from repro_torch.serve import (AdmissionError, DeadlineExceeded,
                               EngineConfig, Knobs, MicroBatcher, Pending,
                               PlanCache, ResultCache, ResultTimeout,
                               bucket_for, earliest_deadline, plan_key,
                               query_fingerprint, shape_buckets)

torch.set_num_threads(2)
L = 128


@pytest.fixture(scope="module")
def small():
    walks = random_walk(512, L, seed=31)
    queries = query_workload(walks, 16, noise_sigma=0.05, seed=32)
    return walks, queries


@pytest.fixture(scope="module")
def index(small):
    walks, _ = small
    return FreshIndex.build(walks, IndexConfig(leaf_capacity=32),
                            device="cpu")


def _build(rows):
    return FreshIndex.build(rows, IndexConfig(leaf_capacity=32),
                            device="cpu")


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same(a, b):
    """Byte equality of two (dist, ids) pairs."""
    for x, y in zip(a, b):
        x, y = _np(x), _np(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


# --------------------------------------------------------------------- #
# plan cache: misses freeze after warmup within an epoch
# --------------------------------------------------------------------- #
def test_misses_frozen_after_warmup(index, small):
    _, queries = small
    with index.engine(EngineConfig(max_batch=8)) as eng:
        eng.warmup(ks=(1, 5), buckets=(1, 2, 4, 8))
        warm = eng.stats()["plan_cache"]
        assert warm["misses"] == 8 and warm["size"] == 8
        futs = [eng.submit(queries[i % 16], k=k)
                for i in range(12) for k in (1, 5)]
        eng.flush()
        for f in futs:
            f.result(timeout=60)
        st = eng.stats()["plan_cache"]
        assert st["misses"] == warm["misses"]
        assert st["hits"] > 0
        assert sum(p.calls for p in eng.plans.plans()) == st["hits"]


def test_epoch_publish_captures_once_then_steady(index, small):
    _, queries = small
    ix = _build(small[0])
    with ix.engine(EngineConfig(max_batch=4)) as eng:
        eng.submit(queries[:4], k=3).result(timeout=60)
        m0 = eng.stats()["plan_cache"]["misses"]
        eng.add(random_walk(8, L, seed=33))     # new epoch -> new plan
        eng.submit(queries[:4], k=3).result(timeout=60)
        m1 = eng.stats()["plan_cache"]["misses"]
        assert m1 == m0 + 1
        eng.submit(queries[:4], k=3).result(timeout=60)
        assert eng.stats()["plan_cache"]["misses"] == m1
        # the dead epoch's plans went with it: one plan lives
        assert eng.stats()["plan_cache"]["size"] == 1
        eng.compact()


def test_plans_of_a_dropped_epoch_are_not_kept(index, small):
    _, queries = small
    with index.engine(EngineConfig(max_batch=4)) as eng:
        snap = eng._snapshots[eng.epoch]
        eng.plans.drop_epochs([snap.epoch])
        plan = eng.plans.get(snap, 4, 3, eng._knobs)
        assert eng.plans.stats()["size"] == 0
        d, i, rounds = plan.run(np.repeat(queries[:1], 4, axis=0))
        assert d.shape == (4, 3) and rounds >= 1


def test_racing_misses_of_one_key_capture_once(index, small, monkeypatch):
    """Threads that miss the same key together make one plan: the first
    captures, the rest wait for it and take it as a hit."""
    import repro_torch.serve.plan_cache as pc
    made = []

    class Slow(pc.CompiledPlan):
        __slots__ = ()

        def __init__(self, *a, **kw):
            made.append(1)
            time.sleep(0.2)                  # a capture's time
            super().__init__(*a, **kw)

    monkeypatch.setattr(pc, "CompiledPlan", Slow)
    with index.engine(EngineConfig(max_batch=4)) as eng:
        snap = eng._snapshots[eng.epoch]
        st0 = eng.plans.stats()
        go = threading.Barrier(6)
        got = []

        def get():
            go.wait()
            got.append(eng.plans.get(snap, 4, 3, eng._knobs))
        threads = [threading.Thread(target=get) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        st = eng.plans.stats()
        assert len(made) == 1 and len(got) == 6
        assert all(p is got[0] for p in got)
        assert st["misses"] - st0["misses"] == 1
        assert st["hits"] - st0["hits"] == 5
        assert st["size"] - st0["size"] == 1


def test_capture_lock_handoff_makes_one_plan(index, monkeypatch):
    """A get that misses a key while its first capture hands over
    (between the capture and the store) waits for that capture and takes
    its plan: 1 plan, 1 miss, 1 hit.  The order is forced through the
    plan_cache.get.* seams, with no sleep: the first get parks at its
    store seam until the second has decided to wait or to capture."""
    import repro_torch.serve.plan_cache as pc
    from repro_torch.analysis.hooks import SyncHook, installed
    made = []

    class Counting(pc.CompiledPlan):
        __slots__ = ()

        def __init__(self, *a, **kw):
            made.append(1)
            super().__init__(*a, **kw)

    monkeypatch.setattr(pc, "CompiledPlan", Counting)
    with index.engine(EngineConfig(max_batch=4, workers=0)) as eng:
        snap = eng._snapshots[eng.epoch]
        cache = PlanCache(torch.device("cpu"))
        first = threading.get_ident()
        decided = threading.Event()
        got = []
        second = threading.Thread(target=lambda: got.append(
            cache.get(snap, 4, 3, eng._knobs)))

        class Order(SyncHook):
            def sync(self, name, obj=None):
                if threading.get_ident() == first:
                    if name == "plan_cache.get.store":
                        second.start()
                        assert decided.wait(30)
                elif name in ("plan_cache.get.capture",
                              "plan_cache.get.wait"):
                    decided.set()

        with installed(Order()):
            plan = cache.get(snap, 4, 3, eng._knobs)
            second.join(timeout=30)
        assert not second.is_alive()
        st = cache.stats()
        assert len(made) == 1 and got == [plan]
        assert (st["misses"], st["hits"], st["size"]) == (1, 1, 1)


def test_a_run_of_the_last_token_takes_its_result(index, small):
    """A helper waiting on the plan's lock for the owner's run of the
    same journal part takes that run's result: the plan runs once."""
    _, queries = small
    with index.engine(EngineConfig(max_batch=4)) as eng:
        snap = eng._snapshots[eng.epoch]
        plan = eng.plans.get(snap, 4, 3, eng._knobs)
        qb = np.repeat(queries[:1], 4, axis=0)
        first = plan.run(qb, token=7)
        assert plan.run(qb, token=7) is first and plan.calls == 1
        plan.run(qb, token=8)
        plan.run(qb)
        assert plan.calls == 3
        outs = []
        plan._lock.acquire()
        threads = [threading.Thread(
            target=lambda: outs.append(plan.run(qb, token=9)))
            for _ in range(2)]
        for t in threads:
            t.start()
        plan._lock.release()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert len(outs) == 2 and outs[0] is outs[1] and plan.calls == 4
        np.testing.assert_array_equal(outs[0][1], first[1])


def test_donate_on_a_cpu_index_raises(index):
    with pytest.raises(ValueError, match="donate"):
        index.engine(EngineConfig(donate=True))
    with pytest.raises(ValueError, match="donate"):
        PlanCache(torch.device("cpu"), donate=True)
    assert PlanCache(torch.device("cpu")).donate is False


def test_plan_key_tracks_knobs():
    assert len(plan_key(3, Knobs())) == 1 + len(dataclasses.fields(Knobs))
    assert plan_key(3, Knobs()) != plan_key(3, Knobs(stop_eps=0.1))
    assert plan_key(3, Knobs()) != plan_key(4, Knobs())
    assert {f.name for f in dataclasses.fields(Knobs)} == {
        "round_leaves", "znorm", "max_rounds", "pq_budget", "sync_every",
        "stop_eps", "stop_leaves"}


# --------------------------------------------------------------------- #
# bit-identity with the facade, ids equal to repro's engine
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def pairs(small, tmp_path_factory):
    """{dtype: (repro index, the port's load of its checkpoint)}."""
    walks, _ = small
    out = {}
    for dtype in ("float32", "bfloat16"):
        jx = JFreshIndex.build(walks[:256], JIndexConfig(
            leaf_capacity=32, dtype=dtype, backend="ref"))
        path = str(tmp_path_factory.mktemp(f"pair_{dtype}"))
        jx.save(path)
        out[dtype] = (jx, FreshIndex.load(path, device="cpu"))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 5, 10])
def test_rows_equal_the_facade_and_ids_repros_engine(pairs, small, dtype,
                                                     k):
    _, queries = small
    jx, ix = pairs[dtype]
    q = queries[:5]                      # pads to bucket 8
    with ix.engine(EngineConfig(max_batch=8)) as eng:
        got = eng.submit(q, k=k).result(timeout=120)
        assert eng.stats()["batches"]["padded_slots"] == 3
    _same(got, ix.search(q, k=k))
    with jx.engine(JEngineConfig(max_batch=8)) as jeng:
        jd, ji = jeng.submit(q, k=k).result(timeout=120)
    np.testing.assert_array_equal(got[1], ji)
    np.testing.assert_allclose(got[0], jd, rtol=1e-5, atol=1e-5)


def test_rows_do_not_depend_on_the_batch(index, small):
    """A query answers with the same bits alone, in any bucket, and in
    the facade's batch of 16."""
    _, queries = small
    full = index.search(queries, k=5)
    with index.engine(EngineConfig(max_batch=8)) as eng:
        for m in (1, 3, 8, 16):
            got = eng.submit(queries[:m], k=5).result(timeout=60)
            _same(got, (full[0][:m], full[1][:m]))


def test_submit_single_query_shapes(index, small):
    _, queries = small
    with index.engine() as eng:
        d1, i1 = eng.submit(queries[0], k=1).result(timeout=60)
        assert d1.shape == (1,) and i1.shape == (1,)
        d5, i5 = eng.submit(torch.from_numpy(queries[0]),
                            k=5).result(timeout=60)
        assert d5.shape == (1, 5) and i5.shape == (1, 5)


# --------------------------------------------------------------------- #
# micro-batcher: the same buckets and batches as repro's
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("max_batch", [1, 7, 8, 12, 64])
def test_buckets_equal_repros(max_batch):
    assert shape_buckets(max_batch) == jshape_buckets(max_batch)
    b = shape_buckets(max_batch)
    for n in range(1, max_batch + 1):
        assert bucket_for(n, b) == jbucket_for(n, b)
    with pytest.raises(ValueError):
        bucket_for(max_batch + 1, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batches_equal_repros_on_the_same_pending_list(seed):
    rng = np.random.default_rng(seed)
    futs = [object() for _ in range(12)]
    kn = (None, Knobs(), Knobs(stop_eps=0.5))
    spec = [(int(rng.integers(1, 14)), int(rng.choice([1, 5])),
             int(rng.integers(0, 2)), i % 3, int(rng.integers(0, 4)),
             None if i % 4 else 1.0) for i in range(12)]
    mk = [rng.standard_normal((m, 16)).astype(np.float32)
          for m, *_ in spec]
    ours = [Pending(x, k, e, futs[i], 0.0, deadline=dl, row0=r0,
                    knobs=kn[j], tier="exact" if j < 2 else "approx@0.9")
            for i, (x, (m, k, e, j, r0, dl)) in enumerate(zip(mk, spec))]
    theirs = [JPending(x, k, e, futs[i], 0.0, deadline=dl, row0=r0,
                       knobs=kn[j], tier="exact" if j < 2 else "approx@0.9")
              for i, (x, (m, k, e, j, r0, dl)) in enumerate(zip(mk, spec))]
    got = MicroBatcher(8).form(ours, now=0.5)
    want = JMicroBatcher(8).form(theirs, now=0.5)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert (a.k, a.epoch, a.n_real, a.knobs, a.tier, a.padded_slots) \
            == (b.k, b.epoch, b.n_real, b.knobs, b.tier, b.padded_slots)
        assert a.queries.tobytes() == b.queries.tobytes()
        assert a.segments == b.segments
    assert earliest_deadline(ours) == 1.0


def test_batcher_groups_pads_and_chunks():
    rng = np.random.default_rng(0)
    mk = lambda m: rng.standard_normal((m, 16)).astype(np.float32)
    pend = [Pending(mk(3), 5, 0, object(), 0.0),
            Pending(mk(2), 5, 0, object(), 0.0),
            Pending(mk(1), 1, 0, object(), 0.0),
            Pending(mk(2), 5, 1, object(), 0.0)]
    batches = MicroBatcher(8).form(pend)
    assert len(batches) == 3
    merged = {(b.epoch, b.k): b for b in batches}[(0, 5)]
    assert merged.n_real == 5 and merged.queries.shape == (8, 16)
    assert merged.padded_slots == 3
    assert [s[1:] for s in merged.segments] == [(0, 0, 3), (3, 0, 2)]
    # padding repeats the chunk's last real row
    assert (merged.queries[5:] == merged.queries[4]).all()
    big = MicroBatcher(4).form([Pending(mk(10), 1, 0, object(), 0.0)])
    assert [b.queries.shape[0] for b in big] == [4, 4, 2]


def test_batcher_deadline_plumbing():
    rng = np.random.default_rng(1)
    mk = lambda m: rng.standard_normal((m, 16)).astype(np.float32)
    live = Pending(mk(2), 1, 0, object(), 0.0, deadline=1e18)
    dead = Pending(mk(1), 1, 0, object(), 0.0, deadline=1.0)
    assert earliest_deadline([live, dead]) == 1.0
    assert earliest_deadline([Pending(mk(1), 1, 0, object(), 0.0)]) is None
    batches = MicroBatcher(4).form([live, dead], now=2.0)
    assert len(batches) == 1 and batches[0].n_real == 2
    off = Pending(mk(2), 1, 0, object(), 0.0, row0=3)
    assert [s[1:] for s in MicroBatcher(4).form([off])[0].segments] == \
        [(0, 3, 2)]


def test_padded_batch_results_match_oracle(small):
    walks, queries = small
    ix = _build(walks)
    q = queries[:5]
    with ix.engine(EngineConfig(max_batch=8)) as eng:
        d, i = eng.submit(q, k=5).result(timeout=60)
        assert eng.stats()["batches"]["padded_slots"] == 3
    db, ib = search_bruteforce(torch.from_numpy(walks), torch.from_numpy(q),
                               k=5)
    np.testing.assert_array_equal(i, ib.numpy())
    np.testing.assert_allclose(d, db.numpy(), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------- #
# snapshot consistency under concurrent writers (Jiffy semantics)
# --------------------------------------------------------------------- #
def test_inflight_batch_answers_on_preadd_snapshot(small):
    walks, queries = small
    base, extra = walks[:256], random_walk(32, L, seed=34)
    ix = _build(base)
    q = torch.from_numpy(queries[:6])
    with ix.engine(EngineConfig(max_batch=8)) as eng:
        f_pre = eng.submit(queries[:6], k=5)
        eng.add(extra)
        f_post = eng.submit(queries[:6], k=5)
        eng.flush()
        d_pre, i_pre = f_pre.result(timeout=60)
        d_post, i_post = f_post.result(timeout=60)
    db, ib = search_bruteforce(torch.from_numpy(base), q, k=5)
    np.testing.assert_array_equal(i_pre, ib.numpy())
    np.testing.assert_allclose(d_pre, db.numpy(), rtol=1e-5, atol=1e-5)
    both = torch.from_numpy(np.concatenate([base, extra]))
    db2, ib2 = search_bruteforce(both, q, k=5)
    np.testing.assert_array_equal(i_post, ib2.numpy())
    np.testing.assert_allclose(d_post, db2.numpy(), rtol=1e-5, atol=1e-5)
    # the post-add rows are the facade's (it scans the same delta rows)
    _same((d_post, i_post), ix.search(queries[:6], k=5))


def test_compact_publishes_and_serves_exactly(small):
    walks, queries = small
    base, extra = walks[:256], random_walk(32, L, seed=35)
    ix = _build(base)
    with ix.engine(EngineConfig(max_batch=8)) as eng:
        eng.add(extra).compact()
        assert eng.epoch == 2 and ix.n_pending == 0
        d, i = eng.submit(queries[:6], k=5).result(timeout=60)
    both = torch.from_numpy(np.concatenate([base, extra]))
    _, ib = search_bruteforce(both, torch.from_numpy(queries[:6]), k=5)
    np.testing.assert_array_equal(i, ib.numpy())


def test_delete_and_update_publish_one_epoch_each(small):
    """A pending delta with tombstones and an update alias: the engine's
    snapshot carries the delta rows and the masked core, and its rows
    equal the facade's; update answers under the stable id."""
    walks, queries = small
    ix = _build(walks[:256])
    with ix.engine(EngineConfig(max_batch=8)) as eng:
        eng.add(walks[256:300])
        e0 = eng.epoch
        assert eng.delete([3, 260, 299]) == 3 and eng.epoch == e0 + 1
        eng.update(7, queries[0])
        assert eng.epoch == e0 + 2
        snap = eng._snapshots[eng.epoch]
        assert snap.delta_rows is not None and snap.delta_alive is not None
        assert torch.equal(snap.delta_rows, ix.delta_rows)
        for k in (1, 5):
            got = eng.submit(queries[:5], k=k).result(timeout=60)
            _same(got, ix.search(queries[:5], k=k))
        d, i = eng.submit(queries[0], k=1).result(timeout=60)
        assert int(i[0]) == 7 and float(d[0]) < 1e-3


def test_recover_restores_and_refuses_a_mesh(small, tmp_path):
    walks, queries = small
    ix = _build(walks[:256])
    ix.save(str(tmp_path))
    with ix.engine(EngineConfig(max_batch=4)) as eng:
        before = eng.submit(queries[:2], k=3).result(timeout=60)
        eng.add(walks[256:270])
        eng.recover(str(tmp_path))
        assert ix.n_pending == 0 and eng.stats()["recoveries"] == 1
        _same(eng.submit(queries[:2], k=3).result(timeout=60), before)
        # a mesh must be a runtime.sharding.Mesh: anything else is refused
        # before the index changes (sharded recovery: test_torch_sharded)
        with pytest.raises(TypeError, match="Mesh"):
            eng.recover(str(tmp_path), mesh=object())
        assert eng.stats()["recoveries"] == 1 and ix.mesh is None


# --------------------------------------------------------------------- #
# journal-backed helping
# --------------------------------------------------------------------- #
def test_orphaned_batch_is_helped_after_worker_crash(index, small):
    _, queries = small
    eng = index.engine(EngineConfig(max_batch=8, workers=1, linger_ms=1.0,
                                    help_after_ms=20.0))
    try:
        crashed = threading.Event()

        def hook(wid, batch):
            if wid >= 0 and not crashed.is_set():
                crashed.set()
                raise WorkerCrash()

        eng._crash_hook = hook
        fut = eng.submit(queries[:3], k=3)
        assert crashed.wait(30), "worker never acquired the batch"
        got = fut.result(timeout=60)     # the caller helps via the journal
        _same(got, index.search(queries[:3], k=3))
        st = eng.stats()
        assert st["workers"]["crashed"] == 1
        assert st["batches"]["helped"] >= 1
    finally:
        eng.close()
    for t in eng._workers:
        assert not t.is_alive()


def test_journal_window_stays_bounded(index, small):
    _, queries = small
    with index.engine(EngineConfig(max_batch=4)) as eng:
        for i in range(6):
            eng.submit(queries[i % 16], k=1).result(timeout=60)
        j = eng._journal
        assert j.stats()["n_parts"] == 6
        assert len(j.parts) == 0
        assert j.stats()["done"] == 6


def test_async_workers_serve_without_flush(index, small):
    _, queries = small
    with index.engine(EngineConfig(max_batch=8, workers=2,
                                   linger_ms=0.5)) as eng:
        futs = [eng.submit(queries[i], k=3) for i in range(8)]
        for f in futs:
            d, i = f.result(timeout=60)
            assert d.shape == (1, 3)
        assert eng.stats()["completed"] == 8
        workers = list(eng._workers)
    for t in workers:
        t.join(timeout=10)
        assert not t.is_alive()


def test_journal_file_survives_restart(index, small, tmp_path):
    """An on-disk journal: a restarted engine adopts the ids and retires
    what the old process left unfinished."""
    _, queries = small
    path = str(tmp_path / "journal.json")
    with index.engine(EngineConfig(max_batch=4, journal_path=path)) as eng:
        for i in range(3):
            eng.submit(queries[i], k=1).result(timeout=60)
    assert os.path.exists(path)
    with index.engine(EngineConfig(max_batch=4, journal_path=path)) as eng:
        assert eng._journal.stats()["n_parts"] == 3
        eng.submit(queries[0], k=1).result(timeout=60)
        assert eng._journal.stats()["n_parts"] == 4


# --------------------------------------------------------------------- #
# stats + validation surface
# --------------------------------------------------------------------- #
def test_stats_surface(index, small):
    _, queries = small
    with index.engine(EngineConfig(max_batch=4)) as eng:
        eng.submit(queries[:4], k=5).result(timeout=60)
        st = eng.stats()
        assert st["queue_depth"] == 0 and st["epoch_lag"] == 0
        assert st["completed"] == 1 and st["qps"] > 0
        assert st["latency_ms"]["p50"] > 0
        assert st["latency_ms"]["p99"] >= st["latency_ms"]["p50"]
        assert st["rounds_per_query"] >= 1
        f = eng.submit(queries[:2], k=1)
        assert eng.stats()["queue_depth"] == 1
        f.result(timeout=60)


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ("tiers", "latency_tiers"):
            out |= _keys(v, prefix + k + "/")
    return out


def test_stats_keys_equal_repros_less_the_mesh(pairs, small):
    _, queries = small
    jx, ix = pairs["float32"]
    with ix.engine(EngineConfig(max_batch=4)) as eng:
        eng.submit(queries[:2], k=3).result(timeout=60)
        ours = _keys(eng.stats())
    with jx.engine(JEngineConfig(max_batch=4)) as jeng:
        jeng.submit(queries[:2], k=3).result(timeout=60)
        theirs = _keys(jeng.stats())
    # the mesh's keys too, now that the port serves sharded indexes
    mesh = {k for k in theirs if k.startswith("mesh")
            or k == "plan_cache/sharded_traces"}
    assert mesh and mesh <= ours and ours == theirs


def test_engine_validation(index, small):
    _, queries = small
    with index.engine() as eng:
        with pytest.raises(ValueError, match="k must be"):
            eng.submit(queries[0], k=0)
        with pytest.raises(ValueError, match="exceeds"):
            eng.submit(queries[0], k=10 ** 9)
        with pytest.raises(ValueError, match="queries must be"):
            eng.submit(np.zeros((2, 17), np.float32))
        with pytest.raises(ValueError, match="queries must be"):
            eng.submit(np.zeros((0, L), np.float32))
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(queries[0])
    with pytest.raises(TypeError):
        EngineConfig(backend="pallas")        # a Pallas knob, not ported
    with pytest.raises(ValueError, match="max_batch"):
        EngineConfig(max_batch=0)
    for bad in (dict(sync_every=0), dict(workers=-1), dict(linger_ms=-1),
                dict(latency_window=0), dict(auto_compact_rows=0),
                dict(latency_tiers={"bulk": 0.9}),
                dict(latency_tiers={"batch": 1.5})):
        with pytest.raises(ValueError):
            EngineConfig(**bad)


def test_engine_overload_validation(index, small):
    _, queries = small
    with index.engine() as eng:
        with pytest.raises(ValueError, match="priority"):
            eng.submit(queries[0], k=1, priority="bulk")
        with pytest.raises(ValueError, match="deadline_ms"):
            eng.submit(queries[0], k=1, deadline_ms=0.0)
    with pytest.raises(ValueError, match="max_pending"):
        EngineConfig(max_pending=0)
    with pytest.raises(ValueError, match="max_pending_per_class"):
        EngineConfig(max_pending_per_class={"bulk": 3})
    with pytest.raises(ValueError, match="overflow_policy"):
        EngineConfig(overflow_policy="drop")
    with pytest.raises(ValueError, match="overflow_deadline_ms"):
        EngineConfig(overflow_deadline_ms=0.0)
    with pytest.raises(ValueError, match="cache_entries"):
        EngineConfig(cache_entries=-1)


# --------------------------------------------------------------------- #
# result cache
# --------------------------------------------------------------------- #
def test_fingerprint_equals_repros(small):
    _, queries = small
    for row in list(queries[:4]) + [np.zeros(L, np.float32),
                                    -np.zeros(L, np.float32)]:
        assert query_fingerprint(row) == jfingerprint(row)
    assert query_fingerprint(np.zeros(4, np.float32)) != \
        query_fingerprint(-np.zeros(4, np.float32))


def test_result_cache_lru_unit():
    c = ResultCache(2)
    for j in range(3):
        c.put(("q", j), np.full(2, j, np.float32), np.full(2, j, np.int32))
    assert len(c) == 2 and c.get(("q", 0)) is None
    d, _ = c.get(("q", 2))
    assert d[0] == 2
    assert c.stats() == {"hits": 1, "misses": 1, "fills": 3,
                         "evictions": 1, "entries": 2, "capacity": 2}
    with pytest.raises(ValueError):
        ResultCache(0)


@pytest.mark.parametrize("k", [1, 5, 10])
def test_cache_hit_bit_identical_to_cold(small, k):
    walks, queries = small
    ix = _build(walks[:256])
    q = queries[:4]
    with ix.engine(EngineConfig(max_batch=4, cache_entries=64)) as eng:
        cold = eng.submit(q, k=k).result(timeout=120)
        assert eng.stats()["result_cache"]["hits"] == 0
        hot = eng.submit(q, k=k).result(timeout=120)
        st = eng.stats()["result_cache"]
        assert st["hits"] == 4 and st["fills"] == 4
    _same(hot, cold)
    _same(hot, ix.search(q, k=k))


def test_cache_add_advances_epoch_and_misses_stale_entry(small):
    walks, queries = small
    ix = _build(walks[:256])
    extra = random_walk(8, L, seed=41)
    q = queries[:2]
    with ix.engine(EngineConfig(max_batch=4, cache_entries=64)) as eng:
        eng.submit(q, k=3).result(timeout=60)
        eng.add(extra)
        _, i1 = eng.submit(q, k=3).result(timeout=60)
        st = eng.stats()["result_cache"]
        assert st["hits"] == 0 and st["misses"] == 4
        assert st["entries"] == 4
    both = torch.from_numpy(np.concatenate([walks[:256], extra]))
    _, ib = search_bruteforce(both, torch.from_numpy(q), k=3)
    np.testing.assert_array_equal(i1, ib.numpy())


def test_cache_partial_hit_row_mapping(small):
    walks, queries = small
    ix = _build(walks[:256])
    with ix.engine(EngineConfig(max_batch=8, cache_entries=64)) as eng:
        eng.submit(queries[1], k=3).result(timeout=60)
        eng.submit(queries[3], k=3).result(timeout=60)
        d, i = eng.submit(queries[:5], k=3).result(timeout=60)
        assert eng.stats()["result_cache"]["hits"] == 2
    _, ib = search_bruteforce(torch.from_numpy(walks[:256]),
                              torch.from_numpy(queries[:5]), k=3)
    np.testing.assert_array_equal(i, ib.numpy())
    _same((d, i), ix.search(queries[:5], k=3))


def test_cache_lru_eviction_respects_capacity(small):
    walks, queries = small
    ix = _build(walks[:256])
    with ix.engine(EngineConfig(max_batch=4, cache_entries=2)) as eng:
        for r in range(3):
            eng.submit(queries[r], k=1).result(timeout=60)
        st = eng.stats()["result_cache"]
        assert st["entries"] == 2 and st["evictions"] == 1
        eng.submit(queries[0], k=1).result(timeout=60)
        st = eng.stats()["result_cache"]
        assert st["hits"] == 0 and st["evictions"] == 2
        eng.submit(queries[2], k=1).result(timeout=60)
        assert eng.stats()["result_cache"]["hits"] == 1


def test_cache_recover_epochs_never_alias(small, tmp_path):
    walks, queries = small
    ix = _build(walks[:256])
    ix.save(str(tmp_path / "ckpt"))
    q = queries[:2]
    with ix.engine(EngineConfig(max_batch=4, cache_entries=64)) as eng:
        first = eng.submit(q, k=3).result(timeout=60)
        e0 = eng.epoch
        eng.recover(str(tmp_path / "ckpt"))
        assert eng.epoch > e0
        again = eng.submit(q, k=3).result(timeout=60)
        st = eng.stats()["result_cache"]
        assert st["hits"] == 0 and st["misses"] == 4
    _same(again, first)


# --------------------------------------------------------------------- #
# admission, deadlines, timeouts
# --------------------------------------------------------------------- #
def test_admission_shed_and_batch_priority_evicted_first(index, small):
    _, queries = small
    eng = index.engine(EngineConfig(max_batch=4, max_pending=4))
    try:
        batch_futs = [eng.submit(queries[i], k=1, priority="batch")
                      for i in range(4)]
        with pytest.raises(AdmissionError, match="budget exhausted"):
            eng.submit(queries[4], k=1, priority="batch")
        assert eng.stats()["overload"]["shed"] == 1
        fi = eng.submit(queries[:3], k=1)
        ov = eng.stats()["overload"]
        assert ov["evicted_batch"] >= 3
        eng.flush()
        fi.result(timeout=60)
        n_shed = 0
        for f in batch_futs:
            assert f.done()
            try:
                f.result(timeout=5)
            except AdmissionError:
                n_shed += 1
        assert n_shed == ov["evicted_batch"]
    finally:
        eng.close()


def test_admission_per_class_budget(index, small):
    _, queries = small
    eng = index.engine(EngineConfig(
        max_batch=4, max_pending_per_class={"batch": 2}))
    try:
        eng.submit(queries[:2], k=1, priority="batch")
        with pytest.raises(AdmissionError):
            eng.submit(queries[2], k=1, priority="batch")
        f = eng.submit(queries[3], k=1)
        eng.flush()
        f.result(timeout=60)
    finally:
        eng.close()


def test_overflow_policy_deadline_queues_with_deadline(index, small):
    _, queries = small
    eng = index.engine(EngineConfig(
        max_batch=4, max_pending=1, overflow_policy="deadline",
        overflow_deadline_ms=1.0))
    try:
        f0 = eng.submit(queries[0], k=1)
        f1 = eng.submit(queries[1], k=1)
        assert eng.stats()["overload"]["overflow_queued"] == 1
        time.sleep(0.01)
        eng.flush()
        f0.result(timeout=60)
        with pytest.raises(DeadlineExceeded):
            f1.result(timeout=5)
        assert eng.stats()["overload"]["deadline_expired"] == 1
    finally:
        eng.close()


def test_deadline_expiry_is_typed_and_counted(index, small):
    _, queries = small
    with index.engine(EngineConfig(max_batch=4)) as eng:
        f = eng.submit(queries[0], k=1, deadline_ms=0.5)
        time.sleep(0.005)
        eng.flush()
        assert f.done()
        with pytest.raises(DeadlineExceeded, match="expired"):
            f.result(timeout=5)
        assert eng.stats()["overload"]["deadline_expired"] == 1
        d, _ = eng.submit(queries[0], k=1,
                          deadline_ms=60_000.0).result(timeout=60)
        assert d.shape == (1,)


def test_result_timeout_typed_and_future_stays_completable(index, small):
    _, queries = small
    eng = index.engine(EngineConfig(max_batch=4))
    try:
        f = eng.submit(queries[:2], k=3)
        orig = eng._make_progress
        eng._make_progress = lambda: None    # starve the sync-mode helper
        t0 = time.monotonic()
        with pytest.raises(ResultTimeout, match="remains completable"):
            f.result(timeout=0.05)
        assert time.monotonic() - t0 < 5.0
        assert not f.done()
        eng._make_progress = orig
        _same(f.result(timeout=60), index.search(queries[:2], k=3))
        assert isinstance(ResultTimeout(), TimeoutError)
    finally:
        eng.close()


# --------------------------------------------------------------------- #
# latency tiers through a calibration table
# --------------------------------------------------------------------- #
def test_latency_tier_serves_the_calibrated_rule(small):
    walks, queries = small
    ix = _build(walks)
    with ix.engine(EngineConfig(max_batch=4,
                                latency_tiers={"batch": 0.9})) as eng:
        with pytest.raises(ValueError, match="calibrat"):
            eng.submit(queries[0], k=5, priority="batch")
    fitted = ix.calibrate(ks=(5,), targets=(0.9,), n_queries=16,
                          eps_grid=(0.0, 0.5), leaves_grid=(2, 16),
                          repeat=1)
    # the fit may pick the exact rule on so small an index (visited
    # leaves tie, the latency decides): pin a rule that stops early
    entry = dataclasses.replace(fitted.lookup(5, 0.9),
                                rule=StopRule(eps=0.5, max_leaves=2))
    ix._calibration = CalibrationTable(fitted.fingerprint,
                                       {(5, 0.9): entry})
    with ix.engine(EngineConfig(max_batch=4,
                                latency_tiers={"batch": 0.9})) as eng:
        eng.warmup(ks=(5,), buckets=(1, 2, 4))
        warm = eng.stats()["plan_cache"]
        assert warm["misses"] == 6           # the exact and the approx plan
        approx = eng.submit(queries[:3], k=5,
                            priority="batch").result(timeout=60)
        exact = eng.submit(queries[:3], k=5).result(timeout=60)
        st = eng.stats()
        assert st["plan_cache"]["misses"] == warm["misses"]
        tiers = st["quality"]["tiers"]
        assert tiers["approx@0.9"]["queries"] == 3
        assert tiers["exact"]["queries"] == 3
        assert tiers["approx@0.9"]["advertised_recall"] >= 0.9
        assert tiers["approx@0.9"]["visited_leaves_per_query"] <= 2
        assert st["quality"]["calibrated"]
    _same(approx, ix.search(queries[:3], k=5, mode="approx",
                            recall_target=0.9))
    _same(exact, ix.search(queries[:3], k=5))


# --------------------------------------------------------------------- #
# engine lifecycle: tests/test_maintenance.py's engine cases
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def life():
    walks = random_walk(96, 64, seed=71)
    extra = random_walk(24, 64, seed=72)
    queries = query_workload(np.concatenate([walks, extra]), 8,
                             noise_sigma=0.05, seed=73)
    return walks, extra, queries


DELETED = [3, 17, 50, 95, 96, 100, 119]


def _lifecycle_index(life):
    walks, extra, _ = life
    ix = FreshIndex.build(walks, IndexConfig(leaf_capacity=16),
                          device="cpu")
    ix.add(extra)
    return ix


def _oracle_alive(life, deleted):
    walks, extra, _ = life
    raw = torch.from_numpy(np.concatenate([walks, extra]))
    alive = torch.ones(raw.shape[0], dtype=torch.bool)
    alive[list(deleted)] = False
    return raw, alive


def test_engine_delete_matches_oracle(life):
    _, _, queries = life
    ix = _lifecycle_index(life)
    with ix.engine(EngineConfig(max_batch=8)) as eng:
        eng.delete(DELETED)
        raw, alive = _oracle_alive(life, DELETED)
        for k in (1, 5, 10):
            d, i = eng.submit(queries, k=k).result(timeout=60)
            d_o, i_o = search_bruteforce(raw, torch.from_numpy(queries),
                                         k=k, alive=alive)
            np.testing.assert_array_equal(i, i_o.numpy())
            np.testing.assert_allclose(d, d_o.numpy(), rtol=1e-5,
                                       atol=1e-5)
            _same((d, i), ix.search(queries, k=k))


def test_engine_cache_hit_cannot_serve_deleted_series(life):
    _, _, queries = life
    ix = _lifecycle_index(life)
    q = np.asarray(queries[:1])
    with ix.engine(EngineConfig(max_batch=4, cache_entries=64)) as eng:
        d0, i0 = eng.submit(q, k=5).result(timeout=60)
        h0 = eng.stats()["result_cache"]["hits"]
        d1, i1 = eng.submit(q, k=5).result(timeout=60)
        assert eng.stats()["result_cache"]["hits"] == h0 + 1
        _same((d1, i1), (d0, i0))
        victim = int(i0[0, 0])
        e0 = eng.epoch
        assert eng.delete([victim]) == 1
        assert eng.epoch > e0
        d2, i2 = eng.submit(q, k=5).result(timeout=60)
        assert victim not in set(i2.ravel().tolist())
        raw, alive = _oracle_alive(life, [victim])
        _, i_o = search_bruteforce(raw, torch.from_numpy(q), k=5,
                                   alive=alive)
        np.testing.assert_array_equal(i2, i_o.numpy())
        eng.add(random_walk(2, 64, seed=76), ttl_s=1e-4)
        e1 = eng.epoch
        time.sleep(0.01)
        assert eng.expire_ttl() == 2
        assert eng.epoch > e1


FAST = FreshnessClass("fast", sweep_interval_s=1e-3,
                      staleness_budget_s=1e-3,
                      compact_delta_rows=10 ** 9, compact_dead_frac=1.0)


def test_auto_compact_rows_and_maintenance_are_exclusive():
    with pytest.raises(ValueError, match="mutually exclusive"):
        EngineConfig(auto_compact_rows=64, maintenance=MaintenancePolicy())
    with pytest.raises(ValueError):
        EngineConfig(maintenance="not a policy")


def test_auto_compact_rows_publishes_a_delta_free_epoch(life):
    walks, extra, queries = life
    ix = FreshIndex.build(walks, IndexConfig(leaf_capacity=16),
                          device="cpu")
    with ix.engine(EngineConfig(max_batch=8, auto_compact_rows=16)) as eng:
        eng.add(extra[:8])
        assert ix.n_pending == 8
        eng.add(extra[8:])
        assert ix.n_pending == 0 and eng.stats()["compactions"] == 1
        _same(eng.submit(queries, k=5).result(timeout=60),
              ix.search(queries, k=5))


def test_maintain_sweeps_expires_and_compacts(life, tmp_path):
    walks, extra, queries = life
    ix = FreshIndex.build(walks, IndexConfig(leaf_capacity=16),
                          device="cpu")
    pol = MaintenancePolicy(freshness=FAST, checkpoint_dir=str(tmp_path),
                            checkpoint_interval_s=1e-3)
    with ix.engine(EngineConfig(max_batch=8, maintenance=pol)) as eng:
        eng.add(extra, ttl_s=1e-3)
        time.sleep(0.01)
        eng.maintain()
        time.sleep(0.01)
        eng.maintain()
        st = eng.stats()["maintenance"]
        assert st["policy"] == "fast"
        assert st["sweeps"] >= 1 and st["compacts"] >= 1
        assert st["checkpoints"] >= 1
        assert ix.n_series == 96 and ix.n_deleted == 0 and ix.n_ttl == 0
        ld = FreshIndex.load(str(tmp_path), device="cpu")
        assert ld.n_series == 96
        _same(eng.submit(queries[:2], k=3).result(timeout=60),
              ld.search(queries[:2], k=3))
    assert any(f.startswith("step_") for f in os.listdir(tmp_path))


def test_background_workers_run_maintenance(life):
    walks, extra, _ = life
    ix = FreshIndex.build(walks, IndexConfig(leaf_capacity=16),
                          device="cpu")
    pol = MaintenancePolicy(freshness=FAST)
    with ix.engine(EngineConfig(max_batch=8, workers=1,
                                maintenance=pol)) as eng:
        eng.add(extra, ttl_s=1e-3)
        deadline = time.time() + 20.0
        while time.time() < deadline:
            st = eng.stats()["maintenance"]
            if st["sweeps"] >= 1 and st["compacts"] >= 1 \
                    and ix.n_pending == 0 and ix.n_deleted == 0:
                break
            time.sleep(0.01)
        st = eng.stats()["maintenance"]
        assert st["sweeps"] >= 1 and st["compacts"] >= 1, st
        assert ix.n_series == 96


# --------------------------------------------------------------------- #
# stress: clients, workers and a writer at once
# --------------------------------------------------------------------- #
def test_clients_workers_and_a_writer_at_once():
    """10 client threads, 3 workers and a writer publishing epochs, with
    a short switch interval: every future completes exactly once, and
    each answers exactly on the epoch it was submitted at."""
    import sys
    walks = random_walk(256, 64, seed=91)
    extras = [random_walk(8, 64, seed=92 + j) for j in range(4)]
    queries = query_workload(walks, 16, noise_sigma=0.05, seed=97)
    ix = FreshIndex.build(walks, IndexConfig(leaf_capacity=16),
                          device="cpu")
    done, errors = [], []
    lock = threading.Lock()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ix.engine(EngineConfig(max_batch=8, workers=3,
                                    linger_ms=0.5)) as eng:
            def client(c):
                try:
                    for j in range(6):
                        r = (c * 6 + j) % 16
                        f = eng.submit(queries[r:r + 1 + j % 3], k=3)
                        got = f.result(timeout=60)
                        with lock:
                            done.append((f.epoch, r, got))
                except Exception as e:      # reported below
                    errors.append(e)

            def writer():
                for x in extras:
                    eng.add(x)
                    time.sleep(0.002)

            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(10)]
            threads.append(threading.Thread(target=writer))
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            assert not errors, errors
            assert eng.stats()["completed"] == len(done) == 60
            assert eng.epoch == len(extras)
    finally:
        sys.setswitchinterval(old)
    for epoch, r, (d, i) in done:
        rows = np.concatenate([walks] + extras[:epoch])
        m = i.shape[0]
        _, ib = search_bruteforce(torch.from_numpy(rows),
                                  torch.from_numpy(queries[r:r + m]), k=3)
        np.testing.assert_array_equal(i, ib.numpy())
