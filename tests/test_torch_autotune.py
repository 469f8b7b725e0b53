"""The port's search-knob autotune (repro_torch.kernels.autotune), held to
repro's contract (tests/test_autotune.py) and to repro's tables:

* persistence: AutotuneTable round-trips through to_dict / save_json and
  through the FreshIndex checkpoint, and tables cross between the
  packages both ways (repro's dma_depth / block_q ignored here);
* the resolution chain: IndexConfig field > fresh table entry > DEFAULTS;
  a stale table, an unknown device or a table from another package
  (stale: the fingerprint hashes each package's own config) falls back
  to the defaults;
* the gate: a candidate that changes any bit is rejected, as repro
  rejects it, and tuned search is bit-identical to untuned search at k
  in {1, 5, 10}, also with a non-default entry forced in.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import FreshIndex as JFreshIndex
from repro.api import IndexConfig as JIndexConfig
from repro.kernels import autotune as jautotune
from repro_torch.api import FreshIndex, IndexConfig
from repro_torch.data.synthetic import query_workload, random_walk
from repro_torch.kernels.autotune import (DEFAULTS, AutotuneTable, TuneConfig,
                                          TuneEntry, candidate_space,
                                          device_kind, resolve_knobs)
from repro_torch.quality.calibrate import index_fingerprint

torch.set_num_threads(2)

L = 64
N = 256
# default, a round_leaves that changes no answer, and a budget that does
CANDS = (TuneConfig(), TuneConfig(round_leaves=16), TuneConfig(pq_budget=2))


@pytest.fixture(scope="module")
def data():
    walks = random_walk(N, L, seed=81)
    queries = query_workload(walks, 8, noise_sigma=0.05, seed=82)
    return walks, queries


def _build(walks, **cfg):
    return FreshIndex.build(walks, IndexConfig(leaf_capacity=8, **cfg),
                            device="cpu")


@pytest.fixture(scope="module")
def tuned(data):
    """One untuned index + one autotuned twin built from the same rows."""
    walks, queries = data
    plain, ix = _build(walks), _build(walks)
    table = ix.autotune(queries=queries, k=5, repeat=1, candidates=CANDS)
    return plain, ix, table


def _entry(rl=16, pq=None):
    return TuneEntry(config=TuneConfig(round_leaves=rl, pq_budget=pq),
                     median_ms=1.0, baseline_ms=2.0, n_candidates=3,
                     n_exact=3)


# --------------------------------------------------------------------- #
# table persistence, within the port and across the packages
# --------------------------------------------------------------------- #
def test_table_roundtrip_dict_and_json(tmp_path):
    t = AutotuneTable("fp-abc123")
    t.put("NVIDIA H100 80GB HBM3", 256, 64, "float32", _entry())
    t.put("cpu", 64, 8, "bfloat16", _entry(rl=8, pq=40))
    path = str(tmp_path / "table.json")
    t.save_json(path)
    for back in (AutotuneTable.from_dict(t.to_dict()),
                 AutotuneTable.load_json(path)):
        assert back.fingerprint == t.fingerprint and len(back) == 2
        assert back.to_dict() == t.to_dict()
        e = back.lookup("NVIDIA H100 80GB HBM3", 256, 64, "float32")
        assert e.config == TuneConfig(round_leaves=16)
        assert e.baseline_ms == 2.0 and e.n_exact == 3
        assert back.lookup("cpu", 64, 8, "bfloat16").config.pq_budget == 40


def test_tuneconfig_from_dict_ignores_unknown_keys():
    d = TuneConfig(round_leaves=16).to_dict()
    d["future_knob"] = 7                     # forward compat
    assert TuneConfig.from_dict(d) == TuneConfig(round_leaves=16)
    # repro's Pallas structure knobs are not the port's
    jd = jautotune.TuneConfig(round_leaves=4, pq_budget=9, dma_depth=2,
                              block_q=4).to_dict()
    assert TuneConfig.from_dict(jd) == TuneConfig(round_leaves=4, pq_budget=9)


def test_tables_cross_between_the_packages():
    jt = jautotune.AutotuneTable("fp-j")
    jt.put("TPU v4", 128, 16, "float32", jautotune.TuneEntry(
        config=jautotune.TuneConfig(round_leaves=16, dma_depth=2),
        median_ms=1.0, baseline_ms=2.0, n_candidates=5, n_exact=4))
    t = AutotuneTable.from_dict(jt.to_dict())
    e = t.lookup("TPU v4", 128, 16, "float32")
    assert e.config == TuneConfig(round_leaves=16)
    assert (e.median_ms, e.baseline_ms, e.n_candidates, e.n_exact) == (
        1.0, 2.0, 5, 4)
    back = jautotune.AutotuneTable.from_dict(t.to_dict())
    assert back.lookup("TPU v4", 128, 16, "float32").config == \
        jautotune.TuneConfig(round_leaves=16)


def test_checkpoint_roundtrip_preserves_table(tmp_path, tuned):
    _, ix, table = tuned
    assert ix.is_autotune_fresh() and ix.stats()["autotuned"]
    ix.save(str(tmp_path))
    ld = FreshIndex.load(str(tmp_path), device="cpu")
    assert ld.autotune_table.to_dict() == table.to_dict()
    assert ld.is_autotune_fresh()
    assert ld.search_knobs() == ix.search_knobs()
    # reload() on a live index adopts the checkpoint's table too
    other = _build(random_walk(N, L, seed=83))
    other.reload(str(tmp_path))
    assert other.autotune_table.to_dict() == table.to_dict()
    assert other.is_autotune_fresh()
    # repro loads the port's table (stale there: another config dict)
    jx = JFreshIndex.load(str(tmp_path))
    assert jx.autotune_table.to_dict()["entries"][0]["config"][
        "round_leaves"] == table.items()[0][1].config.round_leaves
    assert not jx.is_autotune_fresh()


def test_repros_table_crosses_a_checkpoint_and_is_stale_here(data,
                                                             tmp_path):
    walks, queries = data
    jx = JFreshIndex.build(walks, JIndexConfig(leaf_capacity=8,
                                               backend="ref"))
    jt = jautotune.AutotuneTable(jx._fingerprint())
    jt.put(jautotune.device_kind(), L, 8, "float32", jautotune.TuneEntry(
        config=jautotune.TuneConfig(round_leaves=16, pq_budget=2),
        median_ms=1.0, baseline_ms=2.0, n_candidates=2, n_exact=2))
    jx._autotune = jt
    assert jx.search_knobs().pq_budget == 2          # fresh in repro
    jx.save(str(tmp_path))
    ix = FreshIndex.load(str(tmp_path), device="cpu")
    assert ix.autotune_table.lookup(device_kind("cpu"), L, 8, "float32") \
        .config == TuneConfig(round_leaves=16, pq_budget=2)
    assert not ix.is_autotune_fresh()
    assert ix.search_knobs() == TuneConfig(**DEFAULTS)
    # a stale table resolves as in repro: nothing through it
    jx.add(random_walk(1, L, seed=84))
    ix.add(random_walk(1, L, seed=84))
    assert jx.search_knobs().pq_budget is None
    d, i = ix.search(queries, k=5)
    dj, ij = jx.search(jnp.asarray(queries), k=5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))


# --------------------------------------------------------------------- #
# the resolution chain and its fallbacks
# --------------------------------------------------------------------- #
def test_stale_table_is_not_resolved_through(data):
    walks, queries = data
    ix = _build(walks)
    t = AutotuneTable(index_fingerprint(ix))
    t.put(device_kind(ix.device), L, 8, "float32", _entry(rl=16))
    ix._autotune = t
    assert ix.is_autotune_fresh()
    assert ix.search_knobs().round_leaves == 16
    ix.add(random_walk(4, L, seed=84))       # mutate -> fingerprint moves
    assert not ix.is_autotune_fresh()
    assert ix.search_knobs() == resolve_knobs(ix.config, None)


def test_resolve_knobs_defaults_when_nothing_set():
    assert resolve_knobs(None, None) == TuneConfig(**DEFAULTS)
    assert resolve_knobs(IndexConfig(), None) == TuneConfig(**DEFAULTS)
    assert TuneConfig() == TuneConfig(**DEFAULTS)
    assert jautotune.DEFAULTS["round_leaves"] == DEFAULTS["round_leaves"]
    assert jautotune.DEFAULTS["pq_budget"] == DEFAULTS["pq_budget"]


def test_resolve_knobs_config_beats_table_beats_defaults():
    e = _entry(rl=16, pq=50)
    got = resolve_knobs(IndexConfig(round_leaves=32), e)
    assert got.round_leaves == 32            # explicit beats tuned
    assert got.pq_budget == 50               # unset -> tuned entry
    assert resolve_knobs(None, e) == TuneConfig(16, 50)
    assert resolve_knobs(IndexConfig(pq_budget=7), None) == TuneConfig(8, 7)


@pytest.mark.parametrize("kind", ["martian-npu", "TPU v4",
                                  "NVIDIA H100 80GB HBM3"])
def test_unknown_device_falls_back_to_defaults(data, kind):
    walks, _ = data
    ix = _build(walks)
    t = AutotuneTable(index_fingerprint(ix))
    t.put(kind, L, 8, "float32", _entry(rl=16, pq=3))
    ix._autotune = t                         # fresh fingerprint, wrong key
    assert ix.is_autotune_fresh()
    assert device_kind(ix.device) == "cpu"
    assert ix.search_knobs() == TuneConfig(**DEFAULTS)


def test_candidate_space_shape():
    full = candidate_space()
    quick = candidate_space(quick=True)
    assert full[0] == TuneConfig() and quick[0] == TuneConfig()
    assert len(set(full)) == len(full)       # deduped
    assert len(quick) < len(full)
    assert {c.round_leaves for c in full} == {4, 8, 16}
    crossed = candidate_space(round_leaves_grid=(8, 16),
                              pq_budgets=(None, 100))
    assert crossed == (TuneConfig(), TuneConfig(8, 100), TuneConfig(16),
                       TuneConfig(16, 100))


# --------------------------------------------------------------------- #
# the gate, and tuned == untuned bit for bit
# --------------------------------------------------------------------- #
def test_sweep_gates_candidates_and_records_evidence(data, tuned):
    walks, queries = data
    _, ix, table = tuned
    ((key, entry),) = table.items()
    assert key == ("cpu", L, 8, "float32")
    assert entry.n_candidates == len(CANDS)
    # pq_budget=2 changes answers here: rejected, as repro rejects it
    assert entry.n_exact == 2 and entry.config != TuneConfig(pq_budget=2)
    assert entry.median_ms > 0 and entry.baseline_ms > 0
    assert table.fingerprint == index_fingerprint(ix)
    jx = JFreshIndex.build(walks, JIndexConfig(leaf_capacity=8,
                                               backend="ref"))
    jt = jx.autotune(queries=queries, k=5, repeat=1, backend="ref",
                     candidates=tuple(jautotune.TuneConfig(
                         round_leaves=c.round_leaves, pq_budget=c.pq_budget)
                         for c in CANDS))
    assert jt.items()[0][1].n_exact == entry.n_exact


def test_autotuned_search_is_bit_identical_to_untuned(data, tuned):
    _, queries = data
    plain, ix, _ = tuned
    assert ix.is_autotune_fresh()
    for k in (1, 5, 10):
        d0, i0 = plain.search(queries, k=k)
        d1, i1 = ix.search(queries, k=k)
        assert d0.numpy().tobytes() == d1.numpy().tobytes(), k
        assert i0.numpy().tobytes() == i1.numpy().tobytes(), k


def test_installed_nondefault_knobs_stay_bit_identical(data, tuned):
    """Force a NON-default tuned entry (the sweep winner may tie with
    the default) and prove the served answers still match bitwise."""
    walks, queries = data
    plain, _, _ = tuned
    ix = _build(walks)
    t = AutotuneTable(index_fingerprint(ix))
    t.put(device_kind(ix.device), L, 8, "float32", _entry(rl=16))
    ix._autotune = t
    assert ix.search_knobs().round_leaves == 16
    for k in (1, 5, 10):
        d0, i0 = plain.search(queries, k=k)
        d1, i1 = ix.search(queries, k=k)
        assert d0.numpy().tobytes() == d1.numpy().tobytes(), k
        assert i0.numpy().tobytes() == i1.numpy().tobytes(), k


def test_autotune_draws_its_own_holdout(data):
    walks, _ = data
    ix = _build(walks)
    table = ix.autotune(n_queries=4, k=3, repeat=1, quick=True)
    ((key, entry),) = table.items()
    assert entry.n_candidates == len(candidate_space(quick=True))
    assert entry.n_exact == entry.n_candidates    # round_leaves only
    assert ix.autotune_table is table
