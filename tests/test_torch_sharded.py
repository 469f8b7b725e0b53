"""The port's sharded search, sharded serving and recovery, against repro.

repro's side runs once, in a subprocess with
XLA_FLAGS=--xla_force_host_platform_device_count=8 (as
tests/test_sharded.py runs it: the main pytest process keeps one jax
device): it builds an index per storage type from numpy inputs made from
a seed, saves it, and runs its sharded plan (`build_sharded_plan`,
backend "ref") on meshes of 1, 2 and 8 devices at k 1 / 5 / 10,
sync_every 1 / 2, and under the stop rules (eps 0.25, 4 leaves a
shard); it writes the answers, the round counts and `pad_leaves`'s
arrays to an .npz.  The port loads repro's checkpoints (so the stored
bits agree) and runs the same cases in process on meshes of CPU slots:

* parity: ids equal, distances at rtol/atol 1e-5, rounds equal;
* `pad_leaves` bit for bit; reading the loop condition once a chunk
  gives the bits and rounds of a read every round, and no round is
  launched at or past cap * K;
* `mesh_sig` tells 4 slots of one device from 2 slots and from 4
  devices;
* each scenario of tests/test_sharded.py on the port's meshes: facade
  k-NN with a delta and a compact that re-pads 34 leaves to 40, the
  delete oracle, engine bit-identity with no plan made after warmup,
  epochs and auto-compaction, crash helping and recover onto 1 slot,
  checkpoint re-placement, the sharded search against the local one.
"""

import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from repro_torch.api import FreshIndex, IndexConfig
from repro_torch.checkpoint.store import load_checkpoint, save_checkpoint
from repro_torch.core import search
from repro_torch.core.index import pad_leaves
from repro_torch.core.refresh import WorkerCrash
from repro_torch.core.search import (build_sharded_plan,
                                     build_sharded_search, search_bruteforce,
                                     shard_index)
from repro_torch.data.synthetic import query_workload, random_walk
from repro_torch.runtime.sharding import Sharded, make_mesh, mesh_sig
from repro_torch.serve import EngineConfig

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 2,000 walks of 64 in leaves of 16: 125 leaves, padded to 126 for 2
# shards and to 128 for 8; K = 2 leaves a round, so a shard runs up to 8
# (8 shards) to 63 (1 shard) rounds and sync_every matters
N, L, M, RL, NQ = 2000, 64, 16, 2, 12
DTYPES = ("float32", "bfloat16")
MESHES = (1, 2, 8)
KS = (1, 5, 10)
SYNCS = (1, 2)
STOPS = (("eps", dict(stop_eps=0.25)), ("leaves", dict(stop_leaves=4)))
# a slower publication, where it changes the round count (8 slots: 8
# rounds, 6 at sync_every 1 and 2)
SLOW = (("1/8", dict(k=1, sync_every=8)),)

JAX_SIDE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.api import FreshIndex, IndexConfig
from repro.core.index import pad_leaves
from repro.core.search import build_sharded_plan, shard_index
from repro.data.synthetic import random_walk, query_workload
out, N, L, M, RL, NQ = sys.argv[1], {N}, {L}, {M}, {RL}, {NQ}
walks = random_walk(N, L, seed=71)
qs = jnp.asarray(query_workload(walks, NQ, noise_sigma=0.1, seed=72))
res = {{}}
for dt in {DTYPES!r}:
    ix = FreshIndex.build(walks, IndexConfig(leaf_capacity=M, dtype=dt))
    ix.save(out + "/" + dt)
    if dt == "float32":
        # a checkpoint of a sharded index (its padded arrays) and its
        # answer, for the port to load and shard on its own mesh
        sx = FreshIndex.build(walks, IndexConfig(leaf_capacity=M))
        sx.shard(jax.make_mesh((8,), ("data",)))
        sx.add(random_walk(40, L, seed=73))
        sx.delete([5, 1999, 2010])
        sx.save(out + "/sharded")
        d, i = sx.search(qs, k=10, sync_every=2)
        res["saved_sharded/d"], res["saved_sharded/i"] = map(np.asarray,
                                                             (d, i))
    for D in {MESHES!r}:
        mesh = jax.make_mesh((D,), ("data",))
        padded = pad_leaves(ix.index, D)
        for f in padded._fields:
            a = np.asarray(getattr(padded, f))
            if a.dtype.name == "bfloat16":
                a = a.view(np.uint16)
            res[f"pad/{{dt}}/{{D}}/{{f}}"] = a
        sidx = shard_index(padded, mesh)
        cases = [(f"{{k}}/{{s}}", dict(k=k, sync_every=s))
                 for k in {KS!r} for s in {SYNCS!r}]
        cases += [(f"{{name}}/{{s}}", dict(k=5, sync_every=s, **kw))
                  for name, kw in {STOPS!r} for s in {SYNCS!r}]
        cases += list({SLOW!r})
        for key, kw in cases:
            plan = jax.jit(build_sharded_plan(mesh, round_leaves=RL, **kw))
            d, i, r = plan(sidx, qs)
            res[f"{{dt}}/{{D}}/{{key}}/d"] = np.asarray(d)
            res[f"{{dt}}/{{D}}/{{key}}/i"] = np.asarray(i)
            res[f"{{dt}}/{{D}}/{{key}}/r"] = np.asarray(r)
np.savez(out + "/sharded.npz", **res)
""".format(N=N, L=L, M=M, RL=RL, NQ=NQ, DTYPES=DTYPES, MESHES=MESHES,
           KS=KS, SYNCS=SYNCS, STOPS=STOPS, SLOW=SLOW)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """repro's sharded answers ({key: array}) and its checkpoints' root."""
    out = str(tmp_path_factory.mktemp("jax_sharded"))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_SIDE),
                        out], capture_output=True, text=True, env=env,
                       timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    with np.load(os.path.join(out, "sharded.npz")) as z:
        return dict(z), out


@pytest.fixture(scope="module")
def port_indexes(jax_side):
    """The port's index per storage type, loaded from repro's checkpoint."""
    _, out = jax_side
    return {dt: FreshIndex.load(os.path.join(out, dt), device="cpu")
            for dt in DTYPES}


@pytest.fixture(scope="module")
def qs():
    walks = random_walk(N, L, seed=71)
    return torch.tensor(query_workload(walks, NQ, noise_sigma=0.1, seed=72))


def cpu_mesh(D, axis="data"):
    return make_mesh((D,), (axis,), ["cpu"] * D)


def _shards(ix, D):
    mesh = cpu_mesh(D)
    return mesh, shard_index(pad_leaves(ix.index, D), mesh)


CASES = ([(f"{k}/{s}", dict(k=k, sync_every=s)) for k in KS for s in SYNCS]
         + [(f"{name}/{s}", dict(k=5, sync_every=s, **kw))
            for name, kw in STOPS for s in SYNCS] + list(SLOW))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("D", MESHES)
@pytest.mark.parametrize("dt", DTYPES)
def test_sharded_plan_matches_repro(jax_side, port_indexes, qs, dt, D,
                                    case):
    """ids equal, distances within 1e-5, rounds equal, on meshes of 1, 2
    and 8 slots, f32 and bf16, exact and under both stop rules, and at
    sync_every 8."""
    res, _ = jax_side
    key, kw = case
    mesh, shards = _shards(port_indexes[dt], D)
    d, i, rounds = build_sharded_plan(mesh, round_leaves=RL, **kw)(shards,
                                                                   qs)
    want = f"{dt}/{D}/{key}"
    np.testing.assert_array_equal(i.numpy(), res[want + "/i"])
    np.testing.assert_allclose(d.numpy(), res[want + "/d"], rtol=1e-5,
                               atol=1e-5)
    assert rounds == int(res[want + "/r"])


@pytest.mark.parametrize("D", MESHES)
@pytest.mark.parametrize("dt", DTYPES)
def test_pad_leaves_bit_equal_to_repro(jax_side, port_indexes, dt, D):
    res, _ = jax_side
    padded = pad_leaves(port_indexes[dt].index, D)
    assert padded.n_leaves % D == 0
    for f in padded._fields:
        got = getattr(padded, f)
        if got.dtype == torch.bfloat16:
            got = got.view(torch.int16).numpy().view(np.uint16)
        else:
            got = got.numpy()
        want = res[f"pad/{dt}/{D}/{f}"]
        assert got.dtype == want.dtype and got.shape == want.shape, f
        assert got.tobytes() == want.tobytes(), f


def test_a_checkpoint_of_a_sharded_repro_index_loads_and_shards(jax_side,
                                                                qs):
    """repro saved a sharded index (8 devices: 125 leaves padded to 128,
    a pending delta, tombstones in core and delta); the port loads it
    unsharded, searches it locally and on its own meshes of 2 and 8 CPU
    slots: repro's ids, distances within 1e-5."""
    res, out = jax_side
    ix = FreshIndex.load(os.path.join(out, "sharded"), device="cpu")
    assert ix.mesh is None and ix.index.n_leaves == 128
    assert ix.n_pending == 40 and ix.n_deleted == 3
    d, i = ix.search(qs, k=10)
    np.testing.assert_array_equal(i.numpy(), res["saved_sharded/i"])
    for D in (2, 8):
        ix.shard(cpu_mesh(D))
        assert ix.stats()["sharded"] and ix.index.n_leaves == 128
        d, i = ix.search(qs, k=10, sync_every=2)
        np.testing.assert_array_equal(i.numpy(), res["saved_sharded/i"])
        np.testing.assert_allclose(d.numpy(), res["saved_sharded/d"],
                                   rtol=1e-5, atol=1e-5)


def test_one_plan_shared_by_threads(port_indexes, qs):
    """Engine workers share a ShardedPlan across buckets: 8 threads
    running one plan at once (short searches, many of them, the
    interpreter switching threads every microsecond) get the
    single-threaded answer, and the plan's counters lose no update."""
    mesh, shards = _shards(port_indexes["float32"], 2)
    plan = build_sharded_plan(mesh, k=5, round_leaves=RL, sync_every=2,
                              max_rounds=2)
    want = plan(shards, qs[:2])
    one = (plan.rounds, plan.rounds_launched, plan.host_reads)
    n_threads, n_calls = 8, 60
    got, errs = [], []

    def worker():
        try:
            for _ in range(n_calls):
                got.append(plan(shards, qs[:2]))
        except BaseException as e:            # raised below
            errs.append(e)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errs
    assert len(got) == n_threads * n_calls
    for d, i, r in got:
        assert torch.equal(d, want[0]) and torch.equal(i, want[1])
        assert r == want[2]
    calls = 1 + n_threads * n_calls
    assert (plan.rounds, plan.rounds_launched,
            plan.host_reads) == tuple(calls * c for c in one)


def test_pad_leaves_without_padding_is_the_index(port_indexes):
    idx = port_indexes["float32"].index
    assert pad_leaves(idx, 5) is idx                    # 125 leaves


@pytest.mark.parametrize("D", (1, 2, 8))
def test_chunked_condition_equals_every_round(port_indexes, qs, D,
                                              monkeypatch):
    """Reading the loop condition once a chunk (4, doubling to 64, or a
    fixed 3) gives the bits and rounds of a read every round (chunks of
    1); the plan never launches a round at or past cap * K (max_rounds 3
    < the first chunk of 4), and reads the device at most once a
    round."""
    mesh, shards = _shards(port_indexes["float32"], D)

    def run(first, most, **kw):
        monkeypatch.setattr(search, "_FIRST_CHUNK", first)
        monkeypatch.setattr(search, "_MOST_CHUNK", most)
        plan = build_sharded_plan(mesh, round_leaves=RL, **kw)
        return plan, plan(shards, qs)
    for kw in (dict(k=10, sync_every=2), dict(k=5, sync_every=1,
                                               stop_eps=0.25)):
        every, (d1, i1, r1) = run(1, 1, **kw)
        assert every.host_reads <= every.rounds_launched + 1
        for first, most in ((4, 64), (3, 3)):
            plan, (d, i, r) = run(first, most, **kw)
            assert torch.equal(d, d1) and torch.equal(i, i1) and r == r1
            assert plan.rounds == r
            assert r <= plan.rounds_launched < r + 64
            assert plan.host_reads <= every.host_reads
    cap3, (_, _, r) = run(4, 64, k=10, max_rounds=3)
    assert r == 3 and cap3.rounds_launched == 3


@pytest.mark.parametrize("grouping", ["each", "interleaved"])
def test_slots_on_several_devices(port_indexes, qs, monkeypatch, grouping):
    """Slots on different devices are worked as separate groups (their
    own bounds, masks and liveness, the published bound copied to each,
    the union taken back in slot order).  On the CPU every slot is one
    device, so the grouping is forced: each slot its own group, or slots
    0, 2, 4, 6 before 1, 3, 5, 7; the bits and rounds are those of one
    group."""
    mesh, shards = _shards(port_indexes["bfloat16"], 8)
    want = {}
    for kw in (dict(k=10, sync_every=2), dict(k=5, stop_eps=0.25)):
        want[str(kw)] = build_sharded_plan(mesh, round_leaves=RL,
                                           **kw)(shards, qs)
    key = (lambda s, sh: s) if grouping == "each" else \
        (lambda s, sh: s % 2)
    monkeypatch.setattr(search.ShardedPlan, "_group_key",
                        staticmethod(key))
    for kw in (dict(k=10, sync_every=2), dict(k=5, stop_eps=0.25)):
        d, i, r = build_sharded_plan(mesh, round_leaves=RL, **kw)(shards,
                                                                  qs)
        wd, wi, wr = want[str(kw)]
        assert torch.equal(d, wd) and torch.equal(i, wi) and r == wr


def test_the_published_bound_prunes(port_indexes, qs):
    """Each query alone: publishing the global k-th bound every round
    never runs more rounds than never publishing it, and fewer for some
    query; the answers are the same (the bound only prunes)."""
    mesh, shards = _shards(port_indexes["float32"], 2)
    every = build_sharded_plan(mesh, k=1, round_leaves=RL, sync_every=1)
    never = build_sharded_plan(mesh, k=1, round_leaves=RL,
                               sync_every=10 ** 6)
    fewer = 0
    for j in range(NQ):
        d1, i1, r1 = every(shards, qs[j:j + 1])
        d2, i2, r2 = never(shards, qs[j:j + 1])
        assert torch.equal(d1, d2) and torch.equal(i1, i2) and r1 <= r2
        fewer += r1 < r2
    assert fewer > 0


def test_mesh_sig_tells_placements_apart():
    one = make_mesh((4,), ("data",), ["cuda:0"] * 4)
    two = make_mesh((2,), ("data",), ["cuda:0"] * 2)
    four = make_mesh((4,), ("data",), [f"cuda:{i}" for i in range(4)])
    sigs = {mesh_sig(m) for m in (one, two, four)}
    assert len(sigs) == 3
    assert mesh_sig(one) == mesh_sig(make_mesh((4,), ("data",),
                                               ["cuda:0"] * 4))
    assert mesh_sig(one) == (("data",), (4,), (("cuda", 0),) * 4)
    assert one.shape == {"data": 4} and one.size == 4
    with pytest.raises(ValueError):
        make_mesh((4,), ("data",), ["cpu"] * 3)


def test_shards_are_views_on_the_index_device():
    walks = random_walk(512, L, seed=3)
    ix = FreshIndex.build(walks, IndexConfig(leaf_capacity=M), device="cpu")
    before = ix.index.series.data_ptr()
    ix.shard(cpu_mesh(4))
    shards = ix.shard_view()
    assert ix.index.series.data_ptr() == before          # 32 leaves, no pad
    step = shards[0].series.shape[0] * L * 4
    for s, sh in enumerate(shards):
        assert sh.series.data_ptr() == before + s * step
        assert sh.n_leaves == 8
    with pytest.raises(ValueError):
        shard_index(pad_leaves(ix.index, 3), cpu_mesh(5))


# --------------------------------------------------------------------- #
# tests/test_sharded.py, on the port's meshes
# --------------------------------------------------------------------- #
def test_sharded_facade_knn_matches_oracle():
    """FreshIndex.shard(mesh): exact top-k on the sharded path, with a
    delta, and a compact() that re-pads 34 leaves to 40 for 8 slots."""
    walks = random_walk(2048, 256, seed=1)
    qs_ = torch.tensor(query_workload(walks, 12, noise_sigma=0.05, seed=2))
    ix = FreshIndex.build(walks, IndexConfig(leaf_capacity=64),
                          device="cpu")
    ix.shard(cpu_mesh(8))
    assert ix.stats()["sharded"] and ix.mesh.shape == {"data": 8}
    for k in (1, 10):
        d, i = ix.search(qs_, k=k, sync_every=2)
        db, ib = search_bruteforce(torch.tensor(walks), qs_, k=k)
        assert torch.equal(i, ib)
        torch.testing.assert_close(d, db, rtol=1e-5, atol=1e-5)
    extra = random_walk(100, 256, seed=3)        # 2148 series: 34 leaves,
    ix.add(extra)
    both = torch.tensor(np.concatenate([walks, extra]))
    d, i = ix.search(qs_, k=10)                  # the delta, merged
    db, ib = search_bruteforce(both, qs_, k=10)
    assert torch.equal(i, ib)
    ix.compact()                                 # pad_leaves -> 40
    assert ix.index.n_leaves == 40 and ix.mesh is not None
    assert all(sh.n_leaves == 5 for sh in ix.shard_view())
    d, i = ix.search(qs_, k=10)
    assert torch.equal(i, ib)


def test_sharded_delete_matches_tombstone_oracle():
    """delete() masks rows inside the shards (their sentinel norms) and
    the delta (its alive mask); compaction drops them while re-sharding;
    both states bit-equal to the tombstone-aware brute force through the
    facade and the engine."""
    walks = random_walk(512, 128, seed=41)
    extra = random_walk(32, 128, seed=42)
    qs_ = torch.tensor(query_workload(np.concatenate([walks, extra]), 8,
                                      noise_sigma=0.05, seed=43))
    ix = FreshIndex.build(walks, IndexConfig(leaf_capacity=32),
                          device="cpu").shard(cpu_mesh(2))
    ix.add(extra)
    dead = [7, 200, 511, 512, 530]
    assert ix.delete(dead) == len(dead)
    raw = torch.tensor(np.concatenate([walks, extra]))
    alive = torch.ones(544, dtype=torch.bool)
    alive[dead] = False
    for k in (1, 5, 10):
        d, i = ix.search(qs_, k=k)
        db, ib = search_bruteforce(raw, qs_, k=k, alive=alive)
        assert torch.equal(i, ib)
        torch.testing.assert_close(d, db, rtol=1e-5, atol=1e-5)
    ix.compact()
    assert ix.n_series == 544 - len(dead) and ix.n_deleted == 0
    with ix.engine(EngineConfig(max_batch=8)) as eng:
        d, i = eng.submit(qs_, k=10).result(timeout=120)
        db, ib = search_bruteforce(raw, qs_, k=10, alive=alive)
        np.testing.assert_array_equal(i, ib.numpy())
        np.testing.assert_allclose(d, db.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sharded_engine_bit_identical_no_new_plans(dtype):
    """submit().result() byte-equal to FreshIndex.search on the sharded
    index at k 1 / 5 / 10, and no plan made after warmup."""
    walks = random_walk(512, 128, seed=11)
    qs_ = query_workload(walks, 8, noise_sigma=0.05, seed=12)
    ix = FreshIndex.build(walks, IndexConfig(leaf_capacity=32, dtype=dtype),
                          device="cpu").shard(cpu_mesh(2))
    with ix.engine(EngineConfig(max_batch=4, sync_every=2)) as eng:
        eng.warmup(ks=(1, 5, 10), buckets=(4,))
        warm = eng.stats()["plan_cache"]
        assert warm["sharded_traces"] == 3
        for k in (1, 5, 10):
            for _ in range(2):
                d, i = eng.submit(qs_[:4], k=k).result(timeout=120)
                df, if_ = ix.search(torch.tensor(qs_[:4]), k=k,
                                    sync_every=2)
                assert i.tobytes() == if_.numpy().tobytes()
                assert d.tobytes() == df.numpy().tobytes()
        st = eng.stats()["plan_cache"]
        assert st["misses"] == warm["misses"] and st["hits"] > 0
        assert st["sharded_traces"] == 3
        assert all(p.graph is None for p in eng.plans.plans())


def test_sharded_engine_epochs_and_auto_compact():
    """Mesh-wide epochs under add(): the in-flight batch answers on its
    pre-add snapshot, the later submit sees the new series (the delta
    merged), and auto_compact_rows folds the delta and re-shards."""
    walks = random_walk(512, 128, seed=13)
    qs_ = query_workload(walks, 8, noise_sigma=0.05, seed=14)
    extra = random_walk(32, 128, seed=15)
    ix = FreshIndex.build(walks, IndexConfig(leaf_capacity=32),
                          device="cpu").shard(cpu_mesh(2))
    with ix.engine(EngineConfig(max_batch=8)) as eng:
        f_pre = eng.submit(qs_[:4], k=5)
        eng.add(extra)
        f_post = eng.submit(qs_[:4], k=5)
        eng.flush()
        d_pre, i_pre = f_pre.result(timeout=120)
        d_post, i_post = f_post.result(timeout=120)
        _, ib = search_bruteforce(torch.tensor(walks),
                                  torch.tensor(qs_[:4]), k=5)
        np.testing.assert_array_equal(i_pre, ib.numpy())
        both = torch.tensor(np.concatenate([walks, extra]))
        _, ib2 = search_bruteforce(both, torch.tensor(qs_[:4]), k=5)
        np.testing.assert_array_equal(i_post, ib2.numpy())
        df, if_ = ix.search(torch.tensor(qs_[:4]), k=5)
        assert i_post.tobytes() == if_.numpy().tobytes()
        assert d_post.tobytes() == df.numpy().tobytes()
        snap = eng._snapshots[eng.epoch]
        assert snap.mesh is ix.mesh and len(snap.shards) == 2
    ix2 = FreshIndex.build(walks, IndexConfig(leaf_capacity=32),
                           device="cpu").shard(cpu_mesh(2))
    with ix2.engine(EngineConfig(max_batch=8, auto_compact_rows=16)) as eng:
        eng.add(extra)                           # 32 >= 16: auto-compact
        assert ix2.n_pending == 0 and ix2.mesh is not None
        assert eng.stats()["compactions"] == 1
        d, i = eng.submit(qs_[:4], k=10).result(timeout=120)
        _, ib3 = search_bruteforce(both, torch.tensor(qs_[:4]), k=10)
        np.testing.assert_array_equal(i, ib3.numpy())


def test_sharded_engine_crash_helping_and_elastic_recovery(tmp_path):
    """A batch whose worker crashes is re-executed through the journal
    (bit-identical); recover(ckpt, mesh=<1 slot>) restores the arrays,
    re-shards and republishes without dropping the in-flight future."""
    walks = random_walk(512, 128, seed=21)
    qs_ = query_workload(walks, 8, noise_sigma=0.05, seed=22)
    ix = FreshIndex.build(walks, IndexConfig(leaf_capacity=32),
                          device="cpu").shard(cpu_mesh(2))
    eng = ix.engine(EngineConfig(max_batch=8, workers=1, linger_ms=1.0,
                                 help_after_ms=20.0))
    try:
        crashed = threading.Event()

        def hook(wid, batch):
            if wid >= 0 and not crashed.is_set():
                crashed.set()
                raise WorkerCrash()
        eng._crash_hook = hook
        fut = eng.submit(qs_[:3], k=3)
        assert crashed.wait(60), "worker never acquired the batch"
        d, i = fut.result(timeout=120)
        df, if_ = ix.search(torch.tensor(qs_[:3]), k=3)
        assert i.tobytes() == if_.numpy().tobytes()
        assert d.tobytes() == df.numpy().tobytes()
        st = eng.stats()
        assert st["workers"]["crashed"] == 1
        assert st["batches"]["helped"] >= 1
        assert st["mesh"] == {"axes": {"data": 2}, "devices": 2}

        ix.save(str(tmp_path))
        f_old = eng.submit(qs_[:4], k=5)
        eng.recover(str(tmp_path), mesh=cpu_mesh(1))
        f_new = eng.submit(qs_[:4], k=5)
        _, i_o = f_old.result(timeout=120)
        _, i_n = f_new.result(timeout=120)
        _, ib = search_bruteforce(torch.tensor(walks),
                                  torch.tensor(qs_[:4]), k=5)
        np.testing.assert_array_equal(i_o, ib.numpy())
        np.testing.assert_array_equal(i_n, ib.numpy())
        st = eng.stats()
        assert st["recoveries"] == 1
        assert st["mesh"] == {"axes": {"data": 1}, "devices": 1}
        assert ix.mesh.shape == {"data": 1}
    finally:
        eng.close()


def test_recover_keeps_a_local_index_local(tmp_path):
    """recover() without a mesh keeps a local index local; a sharded one
    without a mesh re-meshes over the visible cards, and raises where
    there is none (CPU threads are never devices)."""
    walks = random_walk(256, 64, seed=5)
    ix = FreshIndex.build(walks, IndexConfig(leaf_capacity=16),
                          device="cpu")
    ix.save(str(tmp_path))
    with ix.engine() as eng:
        eng.recover(str(tmp_path))
        assert ix.mesh is None and eng.stats()["mesh"] is None
        eng.recover(mesh=cpu_mesh(2))
        assert eng.stats()["mesh"] == {"axes": {"data": 2}, "devices": 2}
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no healthy devices"):
                eng.recover(str(tmp_path))


def test_elastic_checkpoint_replacement(tmp_path):
    """Save an array, restore it whole on a device and cut over the
    "model" axis of a (2, 4) mesh: the re-mesh path of load_checkpoint."""
    t = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
         "b": torch.arange(8, dtype=torch.float32)}
    save_checkpoint(str(tmp_path), 1, t)
    m2 = make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)
    restored, _ = load_checkpoint(str(tmp_path), t, shardings={
        "w": Sharded(m2, "model"), "b": torch.device("cpu")})
    blocks = restored["w"]
    assert len(blocks) == m2.shape["model"] == 4
    assert all(b.shape == (2, 8) for b in blocks)
    assert torch.equal(torch.cat(blocks), t["w"])
    assert torch.equal(restored["b"], t["b"])
    with pytest.raises(ValueError):
        load_checkpoint(str(tmp_path), t, shardings={
            "w": Sharded(make_mesh((3,), ("data",), ["cpu"] * 3))})


def test_sharded_search_matches_single_device():
    walks = random_walk(2048, 256, seed=1)
    qs_ = torch.tensor(query_workload(walks, 12, noise_sigma=0.05, seed=2))
    ix = FreshIndex.build(walks, IndexConfig(leaf_capacity=64),
                          device="cpu")
    d0, i0, r0 = search.search_plan_impl(ix.index, qs_)
    mesh = cpu_mesh(8)
    fn = build_sharded_search(mesh, sync_every=2)
    d1, i1 = fn(shard_index(ix.index, mesh), qs_)
    torch.testing.assert_close(d1, d0[:, 0], rtol=1e-4, atol=1e-4)
    assert torch.equal(i1, i0[:, 0])
    # one slot: the local plan's rounds and bits
    one = cpu_mesh(1)
    d2, i2, r2 = build_sharded_plan(one, k=1)(shard_index(ix.index, one),
                                              qs_)
    assert torch.equal(d2, d0) and torch.equal(i2, i0) and r2 == r0


def test_sharded_knobs_resolve_like_repro():
    """round_leaves / pq_budget: explicit > config > tune > default."""
    from repro_torch.kernels.autotune import TuneConfig
    mesh = cpu_mesh(2)
    assert build_sharded_plan(mesh).K == 8
    assert build_sharded_plan(mesh, tune=TuneConfig(round_leaves=4)).K == 4
    cfg = IndexConfig(round_leaves=16, pq_budget=32)
    plan = build_sharded_plan(mesh, config=cfg,
                              tune=TuneConfig(round_leaves=4))
    assert plan.K == 16 and plan.leaf_budget == 32
    assert build_sharded_plan(mesh, round_leaves=2, config=cfg).K == 2
    with pytest.raises(ValueError):
        build_sharded_plan(mesh, sync_every=0)
