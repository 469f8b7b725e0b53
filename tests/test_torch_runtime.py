"""The port's runtime pieces that the serving engine stands on, against
repro's on the same inputs: the work journal (each package loads the
journal file the other wrote), the maintenance policy's decisions, and
the rotating CheckpointManager (as tests/test_checkpoint.py holds
repro's)."""

import itertools
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jload_checkpoint
from repro.maintenance import policy as jpolicy
from repro.runtime.journal import WorkJournal as JWorkJournal
from repro_torch.checkpoint.store import (CheckpointManager, latest_step,
                                          load_checkpoint)
from repro_torch.maintenance import (ARCHIVE, HOT, STANDARD, FreshnessClass,
                                     MaintenancePolicy, MaintenanceState)
from repro_torch.runtime import PartState, WorkJournal


# --------------------------------------------------------------------- #
# the work journal
# --------------------------------------------------------------------- #
def _drive(j):
    """One script of journal operations: growth, acquire, done, steal,
    prune; the same on either package's journal."""
    for _ in range(5):
        j.add_part()
    a, b = j.acquire(0), j.acquire(1)
    j.mark_done(a)
    j.steal(b, 7)
    j.mark_done(b)
    c = j.acquire(2)
    j.prune_done()
    return a, b, c


def _file(path):
    with open(path) as f:
        state = json.load(f)
    for p in state["parts"]:
        p["acquired_at"] = p["done_at"] = 0.0
    state["t_avg"] = 0.0
    return state


@pytest.mark.parametrize("writer", ["repro", "port"])
def test_each_package_loads_the_others_journal(tmp_path, writer):
    path = str(tmp_path / "journal.json")
    make, load = ((JWorkJournal, WorkJournal) if writer == "repro"
                  else (WorkJournal, JWorkJournal))
    a, b, c = _drive(make(path, n_parts=0))
    got = load(path, n_parts=0)
    assert got.stats()["n_parts"] == 5 and got.stats()["pruned"] == 2
    assert got.stats()["helped"] == 1 and got.stats()["done"] == 2
    assert got.is_done(a) and got.is_done(b) and not got.is_done(c)
    # a reload clears the dead process's ownership
    assert got.part(c).owner == -1
    assert got.unfinished() == [2, 3, 4]
    # and the other package writes the same file for the same script
    other = str(tmp_path / "other.json")
    _drive((WorkJournal if writer == "repro" else JWorkJournal)(other, 0))
    assert _file(other) == _file(path)


def test_journal_semantics_equal_repros():
    ours, theirs = WorkJournal(None, 4), JWorkJournal(None, 4)
    for j in (ours, theirs):
        assert j.acquire(0) == 0 and j.acquire(1) == 1
        j.mark_done(0)
        j.steal(1, 5)
        j.discard(2)
    for j in (ours, theirs):
        assert j.unfinished() == [1, 3]
        assert j.prune_done() == 1
        assert j.is_done(0) and not j.is_done(1)
    s, t = ours.stats(), theirs.stats()
    assert {k: v for k, v in s.items() if k != "t_avg"} == \
        {k: v for k, v in t.items() if k != "t_avg"}
    with pytest.raises(IndexError, match="pruned"):
        ours.part(0)
    assert isinstance(ours.part(1), PartState) and ours.part(1).helped


def test_journal_snapshot_and_stale_persist(tmp_path):
    p = str(tmp_path / "j.json")
    j = WorkJournal(p, 3, autopersist=False)
    j.acquire(0)
    j.mark_done(0)
    older = j.snapshot()
    j.acquire(1)
    j.mark_done(1)
    newer = j.snapshot()
    j.persist(newer)
    j.persist(older)                 # a delayed older write is dropped
    got = WorkJournal(p, 3)
    assert got.parts[0].done and got.parts[1].done
    assert not got.parts[2].done


def test_journal_backoff_and_help_candidates():
    j = WorkJournal(None, 3)
    j.acquire(0)
    j._t_avg, j._t_cnt = 0.001, 1
    time.sleep(0.01)
    assert set(j.help_candidates()) == {0, 1, 2}
    assert j.backoff_deadline() == pytest.approx(0.002)


# --------------------------------------------------------------------- #
# the maintenance policy
# --------------------------------------------------------------------- #
class _Port:
    """The port's policy names, laid out as repro's policy module."""
    MaintenancePolicy = MaintenancePolicy
    HOT, STANDARD, ARCHIVE = HOT, STANDARD, ARCHIVE


_POLICIES = {
    "standard": lambda m: m.MaintenancePolicy(freshness=m.STANDARD),
    "hot": lambda m: m.MaintenancePolicy(freshness=m.HOT),
    "archive": lambda m: m.MaintenancePolicy(freshness=m.ARCHIVE),
    "compact_every": lambda m: m.MaintenancePolicy.compact_every(
        128, freshness=m.HOT),
    "checkpoints": lambda m: m.MaintenancePolicy(
        freshness=m.STANDARD, checkpoint_dir="ckpt",
        checkpoint_interval_s=5.0),
}


@pytest.mark.parametrize("name", sorted(_POLICIES))
def test_policy_due_equals_repros(name):
    ours, theirs = _POLICIES[name](_Port), _POLICIES[name](jpolicy)
    grid = itertools.product((0, 100), (0, 127, 128, 4096, 70000),
                             (0, 1, 21, 60), (0, 3), (0.0, 1.5, 31.0, 700.0),
                             (0.0, 0.3, 999.0), (0.0, 6.0))
    n = 0
    for vals in grid:
        kw = dict(zip(("n_base", "delta_rows", "dead_rows", "ttl_entries",
                       "oldest_tombstone_age_s", "since_sweep_s",
                       "since_checkpoint_s"), vals))
        assert ours.due(MaintenanceState(**kw)) == \
            theirs.due(jpolicy.MaintenanceState(**kw)), kw
        n += 1
    assert n == 2 * 5 * 4 * 2 * 4 * 3 * 2
    assert ours.checkpoint_cadence() == theirs.checkpoint_cadence()


def test_freshness_presets_and_validation_equal_repros():
    for ours, theirs in ((HOT, jpolicy.HOT), (STANDARD, jpolicy.STANDARD),
                         (ARCHIVE, jpolicy.ARCHIVE)):
        assert ours.__dict__ == theirs.__dict__
    for bad in (dict(sweep_interval_s=0), dict(staleness_budget_s=0),
                dict(compact_delta_rows=0), dict(compact_dead_frac=0.0),
                dict(checkpoint_interval_s=0.0)):
        with pytest.raises(ValueError):
            FreshnessClass("x", **bad)
        with pytest.raises(ValueError):
            jpolicy.FreshnessClass("x", **bad)
    with pytest.raises(ValueError):
        MaintenancePolicy.compact_every(0)
    with pytest.raises(ValueError):
        MaintenancePolicy(checkpoint_interval_s=-1.0)


# --------------------------------------------------------------------- #
# CheckpointManager
# --------------------------------------------------------------------- #
def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(8, 16, generator=g),
            "nested": {"b": torch.arange(10, dtype=torch.int32),
                       "c": (torch.ones(3), torch.zeros(2, 2)),
                       "h": torch.ones(4, dtype=torch.bfloat16)}}


def _equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


def _leaves(t):
    if isinstance(t, dict):
        return [v for k in sorted(t) for v in _leaves(t[k])]
    if isinstance(t, (list, tuple)):
        return [v for x in t for v in _leaves(x)]
    return [t]


def test_latest_step_and_rotation(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 5, 9):
        mgr.save(s, _tree(s))
    assert latest_step(str(tmp_path)) == 9
    kept = sorted(os.listdir(str(tmp_path)))
    assert "step_1" not in kept and "step_5" in kept and "step_9" in kept
    restored, m = load_checkpoint(str(tmp_path), _tree())
    assert m["step"] == 9
    _equal(restored, _tree(9))


def test_async_save_overlaps_and_flushes(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    t = _tree()
    mgr.save(3, t, extra={"epoch": 3})
    # save() took the values at the call: a later in-place write is not
    # in the checkpoint
    t["a"].add_(1.0)
    mgr.wait()
    restored, m = load_checkpoint(str(tmp_path), t)
    assert m["step"] == 3 and m["extra"] == {"epoch": 3}
    _equal(restored, _tree())
    # repro reads what the port's manager wrote
    like = {"a": np.zeros((8, 16), np.float32),
            "nested": {"b": np.zeros(10, np.int32),
                       "c": (np.zeros(3, np.float32),
                             np.zeros((2, 2), np.float32)),
                       "h": np.zeros(4, np.float32)}}
    jrestored, jm = jload_checkpoint(str(tmp_path), like)
    assert jm["step"] == 3
    np.testing.assert_array_equal(np.asarray(jrestored["a"]),
                                  _tree()["a"].numpy())


def test_async_rotation_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    for s in range(1, 6):
        mgr.save(s, _tree(s))
    mgr.wait()
    assert sorted(os.listdir(str(tmp_path))) == ["step_4", "step_5"]
    assert mgr._worker.daemon and mgr._worker.is_alive()


def test_a_write_error_surfaces_on_the_next_call(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = CheckpointManager(str(blocker), keep=2, async_save=True)
    mgr.save(1, _tree())
    with pytest.raises(OSError):
        mgr.wait()
    with pytest.raises(OSError):
        mgr.save(2, _tree())
    done = threading.Event()
    threading.Thread(target=lambda: (mgr._q.join(), done.set()),
                     daemon=True).start()
    assert done.wait(10)
