"""The port's index lifecycle (add with TTL, update, delete, expire_ttl,
compact) against repro's FreshIndex and against a tombstone-aware brute
force, on the CPU.

One scripted sequence runs on both packages with an explicit clock.
After each step n_series and stats() equal repro's, and the search ids
at k in {1, 5, 10} equal repro's and the brute force's over the live
rows as the index stores them (the core's stored series, the delta
z-normalized), for float32 and bfloat16 storage; distances agree at
rtol/atol 1e-5.  prepare_compact/commit_compact refuse a raced token.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import FreshIndex as JFreshIndex
from repro.api import IndexConfig as JIndexConfig
from repro_torch.api import FreshIndex, IndexConfig
from repro_torch.core import isax
from repro_torch.core.search import search_bruteforce
from repro_torch.data.synthetic import query_workload, random_walk

torch.set_num_threads(2)

DELETED = [3, 17, 50, 95, 97, 101]          # core ids and delta ids


@pytest.fixture(scope="module")
def small():
    walks = random_walk(96, 64, seed=71)
    extra = random_walk(24, 64, seed=72)
    fresh = random_walk(8, 64, seed=74)
    queries = query_workload(np.concatenate([walks, extra]), 8,
                             noise_sigma=0.05, seed=73)
    return walks, extra, fresh, queries


def oracle(ix: FreshIndex, queries, k: int):
    """Tombstone-aware brute force over the live rows as `ix` stores them:
    the core's stored series by id, the delta z-normalized; ids of rows
    renamed by update() mapped back to their stable id."""
    core = ix.index
    v = core.valid
    xs = [core.series[v].float()]
    ids = [core.perm[v].long()]
    _, delta, _, id0 = ix.search_view()
    if delta is not None:
        xs.append(isax.znormalize(delta))
        ids.append(id0 + torch.arange(delta.shape[0]))
    x, ids = torch.cat(xs), torch.cat(ids)
    dead = torch.as_tensor(sorted(ix._tombstones), dtype=torch.int64)
    alive = ~torch.isin(ids, dead)
    q = isax.znormalize(torch.as_tensor(queries))
    d, pos = search_bruteforce(x, q, k=k, znorm=False, alive=alive)
    out = torch.where(pos >= 0, ids[pos.long()], torch.full_like(ids[0], -1))
    return d, ix._remap_ids(out.to(torch.int32))


def hold(ix, jx, queries, what):
    assert ix.n_series == jx.n_series, what
    assert ix.n_pending == jx.n_pending and ix.n_deleted == jx.n_deleted
    assert ix.n_ttl == jx.n_ttl, what
    assert ix.stats() == jx.stats(), what
    for k in (1, 5, 10):
        d, i = ix.search(queries, k=k)
        dj, ij = jx.search(jnp.asarray(queries), k=k)
        do, io = oracle(ix, queries, k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ij),
                                      err_msg=f"{what} k={k}: repro")
        np.testing.assert_array_equal(i.numpy(), io.numpy(),
                                      err_msg=f"{what} k={k}: oracle")
        np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(d.numpy(), do.numpy(), rtol=1e-5,
                                   atol=1e-5)
        # no deleted id answers, but a stable id whose row update() renamed
        gone = ix._tombstones - set(ix._alias.values())
        assert not set(i.flatten().tolist()) & gone, what


def script(ix, small, now):
    """The sequence both packages run: each step yields its name."""
    walks, extra, fresh, _ = small
    ix.add(extra[:12])
    ix.add(extra[12:], ttl_s=1000.0)                 # ids 108..119
    yield "add"
    ix.update(5, fresh[0])                           # a core row
    ix.update(100, fresh[1])                         # a delta row
    yield "update"
    assert ix.delete(DELETED) == len(DELETED)
    assert ix.delete(DELETED[:2]) == 0               # already tombstoned
    yield "delete"
    assert ix.expire_ttl(now=now + 10.0) == 0
    assert ix.expire_ttl(now=now + 2000.0) == 12
    yield "expire"
    ix.compact()
    yield "compact"
    assert ix.prepare_compact() is None            # nothing to do
    ix.compact()
    yield "compact again"
    ix.add(fresh[2:6])
    ix.update(5, fresh[6])                           # updated twice
    ix.delete([0, 123])                              # core, then delta
    yield "after compaction"
    ix.compact()
    yield "compact 2"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lifecycle_matches_repro_and_brute_force(small, dtype):
    walks, _, _, queries = small
    ix = FreshIndex.build(walks, IndexConfig(leaf_capacity=16, dtype=dtype),
                          device="cpu")
    jx = JFreshIndex.build(walks, JIndexConfig(leaf_capacity=16,
                                               dtype=dtype))
    hold(ix, jx, queries, "build")
    now = time.monotonic()
    for step, jstep in zip(script(ix, small, now), script(jx, small, now)):
        assert step == jstep
        hold(ix, jx, queries, step)
    assert ix._next_id == jx._next_id == 127
    assert ix.delete([3]) == 0                       # dropped stays dropped


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compact_twice_keeps_the_bits(small, dtype):
    walks, extra, _, _ = small
    ix = FreshIndex.build(walks, IndexConfig(leaf_capacity=16, dtype=dtype),
                          device="cpu")
    ix.add(extra)
    ix.delete([3, 100])
    ix.compact()
    before = ix.index
    assert ix.prepare_compact() is None
    ix.compact()
    assert ix.index is before
    ix.delete([4])
    ix.compact()
    again = FreshIndex.build(walks, IndexConfig(leaf_capacity=16,
                                                dtype=dtype), device="cpu")
    again.add(extra)
    again.delete([3, 100, 4])
    again.compact()
    for f in before._fields:
        assert torch.equal(getattr(ix.index, f), getattr(again.index, f)), f


def test_the_delta_scan_reads_the_rows_compaction_stores(small):
    """delta_rows is the delta as compaction stores it, bit for bit, and
    is cached until the delta changes; a search before compaction and
    after it answers the same ids and distances."""
    walks, extra, fresh, queries = small
    ix = FreshIndex.build(walks, IndexConfig(leaf_capacity=16), device="cpu")
    assert ix.delta_rows is None
    ix.add(extra)
    rows = ix.delta_rows
    assert ix.delta_rows is rows                   # cached
    d, i = ix.search(queries, k=5)
    ix.compact()
    core = ix.index
    at = {int(p): j for j, p in enumerate(core.perm.tolist())}
    stored = core.series[[at[96 + j] for j in range(extra.shape[0])]]
    assert torch.equal(rows, stored)
    d2, i2 = ix.search(queries, k=5)
    assert torch.equal(i2, i) and torch.equal(d2, d)
    ix.add(fresh[:2])
    assert ix.delta_rows.shape == (2, walks.shape[1])


def test_commit_refuses_a_raced_token(small):
    walks, extra, fresh, _ = small
    ix = FreshIndex.build(walks, IndexConfig(leaf_capacity=16), device="cpu")
    ix.add(extra)
    token = ix.prepare_compact()
    ix.add(fresh[:1])
    with pytest.raises(RuntimeError, match="delta changed"):
        ix.commit_compact(token)
    token = ix.prepare_compact()
    ix.delete([7])
    with pytest.raises(RuntimeError, match="tombstones changed"):
        ix.commit_compact(token)
    ix.commit_compact(ix.prepare_compact())
    assert ix.n_pending == 0 and ix.n_deleted == 0
    assert ix.n_series == 96 + 24 + 1 - 1


def test_search_view_masks_arrays_not_storage(small):
    walks, extra, _, _ = small
    ix = FreshIndex.build(walks, IndexConfig(leaf_capacity=16), device="cpu")
    ix.add(extra)
    stored = ix.index.sq_norms.clone()
    ix.delete([3, 100])
    core, delta, alive, id0 = ix.search_view()
    assert core is not ix.index and torch.equal(ix.index.sq_norms, stored)
    assert int((core.sq_norms >= 1e30).sum()) - int(
        (stored >= 1e30).sum()) == 1               # id 3 is a core row
    assert alive is not None and int((~alive).sum()) == 1 and id0 == 96
    assert ix.search_view()[0] is core             # cached
    ix.delete([5])
    assert ix.search_view()[0] is not core


def test_delete_and_ttl_validation(small):
    walks, extra, _, _ = small
    ix = FreshIndex.build(walks, IndexConfig(leaf_capacity=16), device="cpu")
    ix.add(extra, ttl_s=1000.0)
    with pytest.raises(ValueError):
        ix.delete([-1])
    with pytest.raises(ValueError):
        ix.delete([120])                            # never assigned
    with pytest.raises(ValueError):
        ix.add(extra, ttl_s=0.0)
    with pytest.raises(ValueError):
        ix.update(999, extra[0])
    assert ix.n_ttl == 24
    ix.delete([96])
    assert ix.n_ttl == 23                           # delete cancels a TTL
    assert ix.tombstone_age_s >= 0.0
    with pytest.raises(ValueError):
        ix.search(np.zeros(64, np.float32), k=ix.n_series + 1)


@pytest.mark.parametrize("k", [1, 5, 10])
def test_snapshot_search_matches_repros(small, k):
    """The core (dead rows masked) plus an exact scan of the delta (dead
    rows masked), merged with ties to the core: repro's
    snapshot_search_impl on the same index and delta."""
    from repro.core.search import snapshot_search_impl as jsnapshot
    from repro.maintenance import tombstones as jtomb
    from repro_torch.core.search import snapshot_search_impl
    from repro_torch.maintenance import tombstones
    walks, extra, _, queries = small
    ix = FreshIndex.build(walks, IndexConfig(leaf_capacity=16), device="cpu")
    jx = JFreshIndex.build(walks, JIndexConfig(leaf_capacity=16))
    dead = {3, 50, 97, 101}
    core = tombstones.mask_core(ix.index, tombstones.core_dead_mask(
        ix.index.perm, dead))
    alive = tombstones.delta_alive_mask(24, 96, dead, "cpu")
    d, i, rounds = snapshot_search_impl(
        core, torch.from_numpy(extra), torch.from_numpy(queries), alive,
        k=k, n_base=96)
    jcore = jtomb.mask_core(jx.index, jtomb.core_dead_mask(
        np.asarray(jx.index.perm), dead))
    dj, ij, rj = jsnapshot(jcore, jnp.asarray(extra), jnp.asarray(queries),
                           jtomb.delta_alive_mask(24, 96, dead), k=k,
                           n_base=96)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-5)
    assert rounds == int(rj)
    assert not set(i.flatten().tolist()) & dead
