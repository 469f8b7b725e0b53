"""The host-faithful fidelity plane of the port (repro_torch.core.tree,
.baselines, .index.build_index_host, .data.synthetic.seismic_like) on the
CPU: tests/test_tree.py's cases on the port's fat-leaf tree, the
baseline cases of tests/test_refresh.py on the port's baselines,
tests/test_system.py's host-pipeline cases through the port's
build_index_host (device="cpu"), and parity with repro on the same
seeded numpy inputs: the same word sequence builds the same tree, the
host build's words are the one-pass build's, and seismic_like is
byte-equal."""

import threading

import numpy as np
import pytest
import torch

from repro.core import tree as jtree
from repro.core.index import build_index_host as jbuild_index_host
from repro.data.synthetic import seismic_like as jseismic_like
from repro_torch.core.baselines import (CasBased, DoAllSplit, FaiBased,
                                        SingleQueueRefinement)
from repro_torch.core.index import build_index, build_index_host
from repro_torch.core.refresh import Injectors, RefreshExecutor
from repro_torch.core.traverse import (ArrayTraverse, SequentialExecutor,
                                       check_traversing_property)
from repro_torch.core.tree import FatLeafTree, cas_min
from repro_torch.data.synthetic import seismic_like

torch.set_num_threads(2)


def _words(n, segments=16, bits=8, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << bits, size=(n, segments)).astype(np.uint8)


# --------------------------------------------- tests/test_tree.py, ported
def test_sequential_inserts_all_retrievable():
    t = FatLeafTree(leaf_capacity=8, n_threads=2)
    ws = _words(200)
    for i, w in enumerate(ws):
        t.insert(0, w, i, mode="standard")
    assert sorted(pl for _, pl in t.items()) == list(range(200))


def test_split_preserves_membership_and_regions():
    t = FatLeafTree(leaf_capacity=4, n_threads=1)
    ws = _words(64, seed=1)
    for i, w in enumerate(ws):
        t.insert(0, w, i)
    for leaf in t.leaves():
        for e in leaf.data:
            if e is None:
                continue
            w, _ = e
            box, found = t._descend(w)
            assert found is leaf or isinstance(found, type(leaf))


def test_concurrent_inserts_linearizable_membership():
    t = FatLeafTree(leaf_capacity=8, n_threads=8)
    ws = _words(800, seed=2)
    errs = []

    def worker(tid):
        try:
            for i in range(tid * 100, (tid + 1) * 100):
                t.insert(tid, ws[i], i, mode="standard")
        except Exception as e:   # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errs
    assert sorted(set(pl for _, pl in t.items())) == list(range(800))


def test_expeditive_mode_single_owner():
    t = FatLeafTree(leaf_capacity=8, n_threads=2)
    ws = _words(100, seed=3)
    for i, w in enumerate(ws):
        t.insert(0, w, i, mode="expeditive")
    assert sorted(pl for _, pl in t.items()) == list(range(100))


def test_helping_sets_leaf_flag():
    t = FatLeafTree(leaf_capacity=64, n_threads=2)
    w = _words(1, seed=4)[0]
    t.insert(1, w, 0, mode="helping")
    assert t.leaves()[0].help_flag


def test_inorder_and_counts():
    t = FatLeafTree(leaf_capacity=4, n_threads=1)
    ws = _words(40, seed=5)
    for i, w in enumerate(ws):
        t.insert(0, w, i)
    assert len(t.inorder_nodes()) >= 1
    assert len(set(pl for _, pl in t.items())) == 40


def test_cas_min_bsf():
    box = [np.inf]
    assert cas_min(box, 5.0)
    assert not cas_min(box, 7.0)
    assert cas_min(box, 2.0)
    assert box[0] == 2.0


def test_cas_min_concurrent():
    box = [np.inf]
    vals = np.random.default_rng(0).uniform(0, 100, 400)

    def worker(chunk):
        for v in chunk:
            cas_min(box, float(v))

    threads = [threading.Thread(target=worker, args=(vals[i::4],))
               for i in range(4)]
    for t_ in threads:
        t_.start()
    for t_ in threads:
        t_.join()
    assert box[0] == vals.min()


@pytest.mark.parametrize("seed,cap,n", [(0, 2, 20), (1, 4, 75), (2, 8, 150),
                                        (3, 16, 130), (4, 2, 150)])
def test_tree_no_duplicates_random(seed, cap, n):
    """Every payload reachable exactly once via descent-consistent paths
    (tests/test_tree.py's property, on fixed draws)."""
    rng = np.random.default_rng(seed)
    ws = rng.integers(0, 256, size=(n, 8)).astype(np.uint8)
    t = FatLeafTree(segments=8, leaf_capacity=cap, n_threads=1)
    for i, w in enumerate(ws):
        t.insert(0, w, i)
    assert sorted(pl for _, pl in t.items()) == list(range(n))
    for leaf in t.leaves():
        for e in leaf.data:
            if e is not None:
                _, found = t._descend(e[0])
                assert found is leaf


@pytest.mark.parametrize("cap,seed", [(4, 0), (8, 1), (16, 2)])
def test_same_words_build_repros_tree(cap, seed):
    """The same word sequence inserted in order builds repro's tree:
    leaf for leaf, the same payloads in the same slots and depths."""
    ws = _words(300, seed=seed)
    ours = FatLeafTree(leaf_capacity=cap, n_threads=1)
    theirs = jtree.FatLeafTree(leaf_capacity=cap, n_threads=1)
    for i, w in enumerate(ws):
        ours.insert(0, w, i)
        theirs.insert(0, w, i)

    def shape(t):
        return [(type(n).__name__, n.depths.tolist(),
                 [None if e is None else e[1] for e in n.data]
                 if hasattr(n, "data") else n.split_seg)
                for n in t.inorder_nodes()]
    assert shape(ours) == shape(theirs)


# -------------------------------------- tests/test_refresh.py's baselines
def _run(executor_cls, n=200, n_threads=4, injectors=None):
    ex = executor_cls(n_threads=n_threads, injectors=injectors) \
        if injectors else executor_cls(n_threads=n_threads)
    t = ArrayTraverse(ex)
    for i in range(n):
        t.put(i)
    seen = []
    lock = threading.Lock()

    def f(e):
        with lock:
            seen.append(e)

    t.traverse(f)
    return ex, seen


@pytest.mark.parametrize("excls", [DoAllSplit, FaiBased, CasBased])
def test_baselines_traversing_property(excls):
    ex, seen = _run(excls)
    assert check_traversing_property(200, seen)
    assert ex.last_stats.applications >= 200


@pytest.mark.parametrize("excls", [FaiBased, CasBased, DoAllSplit])
def test_baselines_survive_crashes(excls):
    def crash(tid, lvl, i):
        return tid == 0 and i == 5

    ex, seen = _run(excls, injectors=Injectors(crash=crash), n=80)
    assert check_traversing_property(80, seen)


def test_single_queue_refinement_pops_in_order_once_each():
    order = []
    lock = threading.Lock()

    def process(item):
        with lock:
            order.append(item)

    st = SingleQueueRefinement(n_threads=1).run(
        [(3, "c"), (1, "a"), (2, "b")], process)
    assert order == [(1, "a"), (2, "b"), (3, "c")]
    assert st.applications == 3


# --------------------------------- tests/test_system.py's host pipeline
@pytest.fixture(scope="module")
def small(walks):
    return walks[:1024]


def _ids(forest):
    ids = []
    for t in forest.values():
        ids.extend(pl for _, pl in t.items())
    return ids


def test_host_pipeline_inserts_everything(small):
    ex = RefreshExecutor(n_threads=4)
    forest, _ = build_index_host(small, ex, leaf_capacity=16, n_threads=4,
                                 chunk_elems=64, device="cpu")
    assert set(_ids(forest)) == set(range(small.shape[0]))


def test_host_pipeline_with_crashes_matches_sequential(small):
    def crash(tid, lvl, i):
        return tid == 1 and i % 13 == 5

    ex = RefreshExecutor(n_threads=4, injectors=Injectors(crash=crash))
    forest, _ = build_index_host(small, ex, leaf_capacity=16, n_threads=4,
                                 chunk_elems=64, device="cpu")
    assert set(_ids(forest)) == set(range(small.shape[0]))


def test_exactness_independent_of_executor(small):
    results = []
    for ex in (SequentialExecutor(), RefreshExecutor(n_threads=4)):
        forest, _ = build_index_host(small[:256], ex, leaf_capacity=16,
                                     n_threads=4, chunk_elems=32,
                                     device="cpu")
        results.append(sorted(set(_ids(forest))))
    assert results[0] == results[1] == list(range(256))


@pytest.mark.parametrize("excls", [RefreshExecutor, DoAllSplit, FaiBased,
                                   CasBased])
def test_host_words_are_the_one_pass_builds(excls):
    """Under every executor every id sits in the forest, each of its
    entries with the word build_index stores for it, in the bucket of its
    word's first bits; and the forests' buckets hold repro's ids.  An id
    may sit there twice: BC and TP apply each element at least once (a
    helper re-executes a part whose owner it overtook), as repro's do."""
    raw = seismic_like(2048, 64, seed=5)
    forest, _ = build_index_host(raw, excls(n_threads=4), segments=8,
                                 leaf_capacity=16, n_threads=4,
                                 chunk_elems=128, device="cpu")
    ids = _ids(forest)
    assert sorted(set(ids)) == list(range(2048))
    idx = build_index(torch.as_tensor(raw), segments=8, leaf_capacity=16)
    words = np.empty((2048, 8), np.uint8)
    keep = idx.perm >= 0
    words[idx.perm[keep].numpy()] = idx.words[keep].numpy()
    for bucket, t in forest.items():
        for w, pl in t.items():
            np.testing.assert_array_equal(w, words[pl])
            assert int(((w >> 7).astype(np.int64) << np.arange(7, -1, -1)
                        ).sum()) == bucket
    jforest, _ = jbuild_index_host(raw, SequentialExecutor(), segments=8,
                                   leaf_capacity=16, n_threads=4,
                                   chunk_elems=128)
    assert {b: sorted(set(pl for _, pl in t.items()))
            for b, t in forest.items()} == \
        {b: sorted(set(pl for _, pl in t.items()))
         for b, t in jforest.items()}


def test_host_build_defaults_to_the_card(small):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_index_host(small[:8], SequentialExecutor())


# --------------------------------------------------------- seismic_like
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_seismic_like_is_byte_equal_to_repros(seed):
    a = seismic_like(257, 96, seed=seed)
    b = jseismic_like(257, 96, seed=seed)
    assert a.dtype == b.dtype == np.float32
    assert a.tobytes() == b.tobytes()
