"""The slice as a whole: exact k-NN search of the port against repro.

repro builds the index (backend="pallas"), the arrays are carried across
with repro_torch.convert, and both packages search the same index: ids
equal, distances at rtol 1e-5, the same number of refinement rounds, and
both equal to repro's brute-force oracle.  The port's own build-and-search
on the CPU is held against brute force too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import FreshIndex as JFreshIndex
from repro.api import IndexConfig as JIndexConfig
from repro.core import isax as jisax
from repro.core.search import search_bruteforce as jsearch_bruteforce
from repro.core.search import search_plan
from repro_torch import convert
from repro_torch.api import FreshIndex, IndexConfig
from repro_torch.core import search
from repro_torch.data.synthetic import query_workload, random_walk

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def data():
    walks = random_walk(2000, 256, seed=31)       # 2000 % 64: padded leaf
    queries = query_workload(walks, 8, noise_sigma=0.05, seed=32)
    return walks, queries


@pytest.fixture(scope="module")
def jax_indexes(data):
    walks, _ = data
    out = {}
    for bound in ("prefix", "symbox", "paabox"):
        for dtype in ("float32", "bfloat16"):
            cfg = JIndexConfig(bound=bound, dtype=dtype, backend="pallas")
            out[bound, dtype] = JFreshIndex.build(walks, cfg).index
    return out


def _carry(jidx):
    return convert.flat_index_from_numpy(
        {f: np.asarray(getattr(jidx, f)) for f in jidx._fields}, "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bound", ["prefix", "symbox", "paabox"])
@pytest.mark.parametrize("k", [1, 5, 10])
def test_search_matches_repro_on_the_same_index(data, jax_indexes, k, bound,
                                                dtype):
    walks, queries = data
    jidx = jax_indexes[bound, dtype]
    tidx = _carry(jidx)
    assert tidx.series.dtype == (torch.bfloat16 if dtype == "bfloat16"
                                 else torch.float32)
    dj, ij, rj = search_plan(jidx, jnp.asarray(queries), k=k,
                             round_leaves=8, backend="pallas")
    dt, it, rt = search.search_plan_impl(tidx, torch.from_numpy(queries),
                                         k=k, round_leaves=8)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5)
    assert rt == int(rj)
    # the oracle scans the series as the index stores them (bf16-rounded
    # under bf16 storage), in original order; queries normalized as search
    # normalizes them
    perm = np.asarray(jidx.perm)
    stored = np.zeros((len(walks), 256), np.float32)
    stored[perm[perm >= 0]] = np.asarray(jidx.series, np.float32)[perm >= 0]
    _, ib = jsearch_bruteforce(jnp.asarray(stored),
                               jisax.znormalize(jnp.asarray(queries)), k=k,
                               znorm=False)
    np.testing.assert_array_equal(it.numpy().reshape(len(queries), k),
                                  np.asarray(ib).reshape(len(queries), k))
    if dtype == "float32":
        _, ib = jsearch_bruteforce(jnp.asarray(walks), jnp.asarray(queries),
                                   k=k)
        np.testing.assert_array_equal(it.numpy().reshape(len(queries), k),
                                      np.asarray(ib).reshape(len(queries), k))


@pytest.mark.parametrize("k", [1, 10])
def test_port_build_and_search_match_bruteforce(data, k):
    walks, queries = data
    index = FreshIndex.build(walks, IndexConfig(bound="paabox"),
                             device="cpu")
    assert index.n_series == len(walks) and index.series_len == 256
    d, i = index.search(queries, k=k)
    db, ib = search.search_bruteforce(torch.from_numpy(walks),
                                      torch.from_numpy(queries), k=k)
    assert d.shape == ((len(queries),) if k == 1 else (len(queries), k))
    np.testing.assert_array_equal(i.numpy(), ib.numpy())
    np.testing.assert_allclose(d.numpy(), db.numpy(), rtol=1e-5)
    _, ij = jsearch_bruteforce(jnp.asarray(walks), jnp.asarray(queries), k=k)
    np.testing.assert_array_equal(ib.numpy(), np.asarray(ij))


def test_from_arrays_and_a_single_query(data, jax_indexes):
    walks, queries = data
    jidx = jax_indexes["prefix", "float32"]
    index = FreshIndex.from_arrays(
        {f: np.asarray(getattr(jidx, f)) for f in jidx._fields},
        IndexConfig(), device="cpu")
    d, i = index.search(queries[0], k=3)
    _, ib = jsearch_bruteforce(jnp.asarray(walks), jnp.asarray(queries[:1]),
                               k=3)
    assert d.shape == (1, 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ib))
    with pytest.raises(ValueError):
        index.search(queries, k=0)
    with pytest.raises(ValueError):
        index.search(queries[:, :128], k=1)
    with pytest.raises(KeyError):
        convert.flat_index_from_numpy({"series": np.zeros((1, 1))}, "cpu")


# name, IndexConfig fields, TuneConfig (round_leaves, pq_budget), the
# explicit round_leaves, and the (round_leaves, pq_budget) repro resolves
KNOBS = [("defaults", {}, None, None, (8, None)),
         ("config", dict(round_leaves=16, pq_budget=12), None, None,
          (16, 12)),
         ("tune", {}, (4, 10), None, (4, 10)),
         ("config_over_tune", dict(round_leaves=16), (4, 10), None,
          (16, 10)),
         ("argument_over_config", dict(round_leaves=16, pq_budget=12), None,
          2, (2, 12))]


@pytest.mark.parametrize("name,cfg,tune,K_arg,want", KNOBS,
                         ids=[kn[0] for kn in KNOBS])
def test_run_search_resolves_config_and_tune_as_repro(
        data, jax_indexes, monkeypatch, name, cfg, tune, K_arg, want):
    """run_search takes config= and tune= and resolves round_leaves and
    pq_budget as repro's: argument, config, tune, 8 / uncapped.  The ids
    and distances are repro's run_search's; the knobs it resolved give
    repro's rounds in repro's plan."""
    from repro.core.search import run_search as jrun_search
    from repro.kernels.autotune import TuneConfig as JTuneConfig
    from repro_torch.kernels.autotune import TuneConfig
    _, queries = data
    jidx = jax_indexes["prefix", "float32"]
    tidx = _carry(jidx)
    seen = []
    plan = search.search_plan_impl

    def spy(*args, **kw):
        seen.append((kw["round_leaves"], kw["pq_budget"]))
        out = plan(*args, **kw)
        seen.append(out[2])
        return out
    monkeypatch.setattr(search, "search_plan_impl", spy)
    dt, it = search.run_search(
        tidx, torch.from_numpy(queries), k=5, round_leaves=K_arg,
        config=IndexConfig(**cfg), tune=TuneConfig(*tune) if tune else None)
    dj, ij = jrun_search(
        jidx, jnp.asarray(queries), k=5, round_leaves=K_arg,
        config=JIndexConfig(**cfg), tune=JTuneConfig(*tune) if tune else None)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5)
    assert seen[0] == want
    _, _, rj = search_plan(jidx, jnp.asarray(queries), k=5,
                           round_leaves=want[0], pq_budget=want[1])
    assert seen[1] == int(rj)


def test_deprecated_search_warns_and_answers_as_repro(data, jax_indexes):
    """repro_torch.core.search.search warns (naming the facade) and
    answers as run_search; its ids are repro's deprecated search's."""
    from repro.core import search as jdeprecated
    _, queries = data
    jidx = jax_indexes["paabox", "float32"]
    tidx = _carry(jidx)
    q = torch.from_numpy(queries)
    cfg = dict(round_leaves=4)
    with pytest.warns(DeprecationWarning, match="FreshIndex"):
        d, i = search.search(tidx, q, k=5, config=IndexConfig(**cfg))
    with pytest.warns(DeprecationWarning, match="FreshIndex"):
        d1, i1 = search.search(tidx, q, k=1)
    d0, i0 = search.run_search(tidx, q, k=5, config=IndexConfig(**cfg))
    assert torch.equal(d, d0) and torch.equal(i, i0)
    assert torch.equal(d1, d0[:, 0]) and torch.equal(i1, i0[:, 0])
    with pytest.warns(DeprecationWarning, match="FreshIndex"):
        dj, ij = jdeprecated(jidx, jnp.asarray(queries), k=5,
                             config=JIndexConfig(**cfg))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-5)


def test_deprecated_make_sharded_search_warns_and_answers_as_repro(
        data, jax_indexes):
    """repro_torch.core's make_sharded_search warns (naming the facade)
    and returns build_sharded_search's function: on 2 CPU slots its
    answer is build_sharded_search's, and its ids those of repro's
    deprecated make_sharded_search on a 1-device mesh."""
    import jax
    from repro.core import make_sharded_search as jdeprecated
    from repro.core.search import shard_index as jshard_index
    from repro_torch.core import make_sharded_search
    from repro_torch.runtime import make_mesh
    _, queries = data
    jidx = jax_indexes["prefix", "float32"]
    tidx = _carry(jidx)
    q = torch.from_numpy(queries)
    mesh = make_mesh((2,), ("data",), ["cpu"] * 2)
    shards = search.shard_index(tidx, mesh)
    with pytest.warns(DeprecationWarning, match="FreshIndex.shard"):
        fn = make_sharded_search(mesh, k=5, sync_every=2)
    d, i = fn(shards, q)
    d0, i0 = search.build_sharded_search(mesh, k=5, sync_every=2)(shards, q)
    assert torch.equal(d, d0) and torch.equal(i, i0)
    jmesh = jax.make_mesh((1,), ("data",))
    with pytest.warns(DeprecationWarning, match="FreshIndex.shard"):
        jfn = jdeprecated(jmesh, k=5, sync_every=2)
    dj, ij = jfn(jshard_index(jidx, jmesh), jnp.asarray(queries))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-5)
