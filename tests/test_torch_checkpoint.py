"""Checkpoints cross between the packages: the port loads what repro
saved (lifecycle state included) and answers repro's ids, and repro
loads what the port saved.  The store itself (repro_torch.checkpoint)
writes repro's layout: step_<N>/, manifest.json, one .npy per leaf,
bfloat16 as uint16 bit patterns."""

import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import FreshIndex as JFreshIndex
from repro.api import IndexConfig as JIndexConfig
from repro.checkpoint import store as jstore
from repro_torch.api import FreshIndex, IndexConfig
from repro_torch.checkpoint import store
from repro_torch.data.synthetic import query_workload, random_walk

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def data():
    walks = random_walk(200, 64, seed=81)
    extra = random_walk(30, 64, seed=82)
    queries = query_workload(np.concatenate([walks, extra]), 6,
                             noise_sigma=0.05, seed=83)
    return walks, extra, queries


def _lifecycle(ix, extra):
    """Pending delta, tombstones in core and delta, a TTL, an alias."""
    ix.add(extra[:20])
    ix.add(extra[20:], ttl_s=1000.0)
    ix.delete([3, 150, 205])
    ix.update(7, extra[0] * 0.5)
    return ix


def _same_state(a, b):
    assert a.n_series == b.n_series and a.n_pending == b.n_pending
    assert a.n_deleted == b.n_deleted and a.n_ttl == b.n_ttl
    assert a._next_id == b._next_id and a._delta_id0 == b._delta_id0
    assert a._tombstones == b._tombstones and a._alias == b._alias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_port_loads_repros_checkpoint(data, dtype, tmp_path):
    walks, extra, queries = data
    jx = _lifecycle(JFreshIndex.build(walks, JIndexConfig(
        leaf_capacity=16, dtype=dtype, backend="pallas")), extra)
    jx.save(str(tmp_path), step=3)
    ix = FreshIndex.load(str(tmp_path), device="cpu")
    assert ix.config == IndexConfig(leaf_capacity=16, dtype=dtype)
    _same_state(ix, jx)
    for f in ix.index._fields:                      # the same bits
        a = getattr(ix.index, f)
        b = np.asarray(getattr(jx.index, f))
        if b.dtype.name == "bfloat16":
            a, b = a.view(torch.int16), b.view(np.int16)
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
    for k in (1, 5, 10):
        d, i = ix.search(queries, k=k)
        dj, ij = jx.search(jnp.asarray(queries), k=k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
        np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-5,
                                   atol=1e-5)
    # the lifecycle carries on from the checkpoint as repro's does
    now = time.monotonic() + 2000.0
    assert ix.expire_ttl(now=now) == jx.expire_ttl(now=now) == 10
    ix.compact()
    jx.compact()
    d, i = ix.search(queries, k=5)
    np.testing.assert_array_equal(
        i.numpy(), np.asarray(jx.search(jnp.asarray(queries), k=5)[1]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_repro_loads_the_ports_checkpoint(data, dtype, tmp_path):
    walks, extra, queries = data
    ix = _lifecycle(FreshIndex.build(walks, IndexConfig(
        leaf_capacity=16, dtype=dtype), device="cpu"), extra)
    path = ix.save(str(tmp_path), step=5)
    assert os.path.basename(path) == "step_5"
    jx = JFreshIndex.load(str(tmp_path))
    assert jx.config == JIndexConfig(leaf_capacity=16, dtype=dtype)
    _same_state(ix, jx)
    for k in (1, 5, 10):
        d, i = ix.search(queries, k=k)
        dj, ij = jx.search(jnp.asarray(queries), k=k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
        np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-5,
                                   atol=1e-5)


def test_save_load_reload_are_bit_equal(data, tmp_path):
    walks, extra, queries = data
    ix = _lifecycle(FreshIndex.build(walks, IndexConfig(leaf_capacity=16),
                                     device="cpu"), extra)
    ix.save(str(tmp_path), step=1)
    ld = FreshIndex.load(str(tmp_path), device="cpu")
    _same_state(ix, ld)
    for f in ix.index._fields:
        assert torch.equal(getattr(ix.index, f), getattr(ld.index, f)), f
    d0, i0 = ix.search(queries, k=5)
    d1, i1 = ld.search(queries, k=5)
    assert torch.equal(d0, d1) and torch.equal(i0, i1)
    ix.compact()
    assert ix.n_pending == 0
    ix.reload(str(tmp_path))                       # back to step 1
    _same_state(ix, ld)
    d2, i2 = ix.search(queries, k=5)
    assert torch.equal(d2, d0) and torch.equal(i2, i0)
    other = FreshIndex.build(walks, IndexConfig(leaf_capacity=32),
                             device="cpu")
    with pytest.raises(ValueError, match="config"):
        other.reload(str(tmp_path))


def test_carried_dicts_survive_a_round_trip(data, tmp_path):
    """A repro checkpoint with a quality_calibration and an autotune table
    loads; the port reads both tables and writes them back in repro's
    format (the autotune entries without repro's Pallas structure knobs,
    which read back as their defaults)."""
    from repro.kernels import autotune as jautotune
    walks, _, queries = data
    jx = JFreshIndex.build(walks, JIndexConfig(leaf_capacity=16))
    jx.calibrate(ks=(5,), targets=(0.9,), queries=queries, eps_grid=(0.0,),
                 leaves_grid=(4,), repeat=1)
    jt = jautotune.AutotuneTable("fp-x")
    jt.put("x", 64, 16, "float32", jautotune.TuneEntry(
        config=jautotune.TuneConfig(round_leaves=16), median_ms=1.0,
        baseline_ms=2.0, n_candidates=2, n_exact=2))
    jx._autotune = jt
    jx.save(str(tmp_path / "a"), step=0)
    m = json.loads((tmp_path / "a" / "step_0" / "manifest.json")
                   .read_text())
    ix = FreshIndex.load(str(tmp_path / "a"), device="cpu")
    assert ix.stats()["calibrated"] and ix.stats()["autotuned"]
    ix.save(str(tmp_path / "b"), step=0)
    back = json.loads((tmp_path / "b" / "step_0" / "manifest.json")
                      .read_text())["extra"]
    assert back["quality_calibration"] == m["extra"]["quality_calibration"]
    assert jautotune.AutotuneTable.from_dict(back["autotune"]).to_dict() \
        == m["extra"]["autotune"]


def test_store_layout_matches_repros(tmp_path):
    tree = {"b": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "a": {"x": torch.tensor([1.5, -2.0]).to(torch.bfloat16),
                  "y": np.ones(3, np.float16)}}
    store.save_checkpoint(str(tmp_path), 4, tree, extra={"k": 1})
    store.save_checkpoint(str(tmp_path), 2, tree)
    assert store.latest_step(str(tmp_path)) == 4
    assert store.latest_step(str(tmp_path / "none")) is None
    arrays, manifest = jstore.load_arrays(str(tmp_path))
    assert sorted(arrays) == ["a/x", "a/y", "b"]
    assert manifest["leaves"]["a/x"]["dtype"] == "bfloat16"
    np.testing.assert_array_equal(np.asarray(arrays["a/x"], np.float32),
                                  [1.5, -2.0])
    mine, m2 = store.load_arrays(str(tmp_path), step=4)
    assert m2["extra"] == {"k": 1} and mine["a/x"].dtype == torch.bfloat16
    back, _ = store.load_checkpoint(str(tmp_path), tree)
    assert torch.equal(back["b"], tree["b"])
    assert torch.equal(back["a"]["x"], tree["a"]["x"])
    assert back["a"]["y"].dtype == torch.float16
    with pytest.raises(FileNotFoundError):
        store.load_arrays(str(tmp_path / "none"))
