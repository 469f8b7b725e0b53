"""The port never falls back and never reaches for JAX.

* Entry points default to the card and raise where there is none.
* Kernel wrappers raise on input their kernel does not take, and on a
  CPU tensor run the plain version without counting a launch.
* The kernel loader raises when there is no nvcc, before writing anything.
* Importing every module of repro_torch loads neither jax nor repro.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.kernels import (_build, dtw, ed_argmin, flash_attention,
                                 isax_summarize, lb_distance, ops, refine,
                                 refine_search)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_build_without_a_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    x = np.zeros((64, 256), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.FreshIndex.build(x)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.FreshIndex.build(x, device="cuda")


def test_approx_search_and_calibrate_without_a_device_need_cuda(tmp_path):
    """Approximate search and calibration run where the index lives: an
    index made or loaded without a device is one on the card, so on a
    machine without CUDA they raise before any search runs."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    x = np.random.default_rng(0).standard_normal((64, 64)).cumsum(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.FreshIndex.build(x).search(x[:2], k=3, mode="approx",
                                       stop_eps=0.1)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.FreshIndex.build(x).calibrate(ks=(3,), n_queries=4)
    cpu = api.FreshIndex.build(x, api.IndexConfig(leaf_capacity=8),
                               device="cpu")
    cpu.calibrate(ks=(3,), n_queries=4, eps_grid=(0.0, 0.5),
                  leaves_grid=(2,), repeat=1)
    cpu.save(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        api.FreshIndex.load(str(tmp_path))
    back = api.FreshIndex.load(str(tmp_path), device="cpu")
    assert back.is_calibration_fresh()
    d, i = back.search(x[:2], k=3, mode="approx", recall_target=0.95)
    assert d.device.type == "cpu" and i.shape == (2, 3)
    # the kernel's wrapper takes the (1 + eps) stop on the CPU's plain
    # version only; on any other device it launches or raises
    q = torch.zeros(2, 64, device="meta")
    with pytest.raises(RuntimeError, match="meta"):
        refine_search.refine_search(
            q, torch.zeros(2, device="meta"), torch.zeros(32, 64,
                                                          device="meta"),
            torch.zeros(32, device="meta"),
            torch.zeros(2, 8, dtype=torch.int32, device="meta"),
            torch.zeros(2, 8, device="meta"), leaf_capacity=8, k=2,
            round_leaves=4, inv_eps=0.5)


def test_config_and_data_are_validated():
    with pytest.raises(ValueError):
        api.IndexConfig(bound="box")
    with pytest.raises(ValueError):
        api.IndexConfig(dtype="int8")
    with pytest.raises(ValueError):
        api.IndexConfig(round_leaves=0)
    with pytest.raises(ValueError):
        api.FreshIndex.build(np.zeros((4, 250), np.float32), device="cpu")
    with pytest.raises(ValueError):
        api.FreshIndex.build(np.zeros((256,), np.float32), device="cpu")
    # n = 0 is the bootstrap (build empty, add, compact), as in repro
    empty = api.FreshIndex.build(np.zeros((0, 256), np.float32),
                                 device="cpu")
    assert empty.n_series == 0 and empty.index.n_leaves == 0


def test_wrappers_raise_on_what_the_kernel_does_not_take():
    x = torch.zeros(8, 256)
    with pytest.raises(TypeError):
        isax_summarize.summarize(x.double())
    with pytest.raises(ValueError):
        isax_summarize.summarize(x.t())                  # not contiguous
    with pytest.raises(ValueError):
        isax_summarize.summarize(x, segments=15)
    q, lo = torch.zeros(2, 16), torch.zeros(5, 16)
    with pytest.raises(TypeError):
        lb_distance.lb_distance(q.double(), lo, lo)
    with pytest.raises(ValueError):
        lb_distance.lb_distance(q, lo, torch.zeros(5, 8))
    args = dict(q=torch.zeros(2, 64), q_sq=torch.zeros(2),
                series=torch.zeros(4 * 8, 64), sq_norms=torch.zeros(32),
                leaf_ids=torch.zeros(2, 3, dtype=torch.int32),
                alive=torch.ones(2, 3, dtype=torch.bool),
                bsf_d=torch.full((2, 5), 1e30),
                bsf_e=torch.zeros(2, 5, dtype=torch.int32))
    refine.refine_topk(**args, leaf_capacity=8, k=5)
    for name, bad in (("leaf_ids", torch.zeros(2, 3, dtype=torch.int64)),
                      ("alive", torch.ones(2, 3, dtype=torch.int32)),
                      ("series", torch.zeros(30, 64)),
                      ("bsf_d", torch.full((2, 4), 1e30))):
        with pytest.raises(ValueError):
            refine.refine_topk(**{**args, name: bad}, leaf_capacity=8, k=5)
    with pytest.raises(TypeError):
        refine.refine_topk(**{**args, "series": torch.zeros(32, 64).double()},
                           leaf_capacity=8, k=5)


def test_scan_and_attention_wrappers_raise_on_what_the_kernel_does_not_take():
    q, xs = torch.zeros(2, 64), torch.zeros(9, 64)
    ed_argmin.ed_argmin(q, xs)
    ed_argmin.ed_argmin(q, xs.bfloat16())
    for bad_q, bad_xs, err in ((q.double(), xs, TypeError),
                               (q, xs.half(), TypeError),
                               (q, torch.zeros(9, 32), ValueError),
                               (q[0], xs, ValueError),
                               (q, xs.t(), ValueError),
                               (q, xs[:0], ValueError),
                               (q[:0], xs, ValueError)):
        with pytest.raises(err):
            ed_argmin.ed_argmin(bad_q, bad_xs)
    qa, ka = torch.zeros(1, 4, 8, 32), torch.zeros(1, 2, 8, 32)
    flash_attention.flash_attention(qa, ka, ka)
    for args, err in (((qa, torch.zeros(1, 3, 8, 32),
                        torch.zeros(1, 3, 8, 32)), ValueError),  # Hq % Hkv
                      ((qa, ka, torch.zeros(1, 2, 8, 16)), ValueError),
                      ((qa, torch.zeros(1, 2, 8, 16),
                        torch.zeros(1, 2, 8, 16)), ValueError),
                      ((qa.double(), ka.double(), ka.double()), TypeError),
                      ((qa, ka.bfloat16(), ka.bfloat16()), TypeError),
                      ((qa.transpose(2, 3), ka, ka), ValueError),
                      ((qa[0], ka, ka), ValueError)):
        with pytest.raises(err):
            flash_attention.flash_attention(*args)
    with pytest.raises(ValueError):
        flash_attention.flash_attention(qa, ka, ka, window=-1)


def test_cpu_tensors_run_the_plain_version_and_count_nothing():
    before = (isax_summarize.launches, lb_distance.launches,
              refine.launches, refine_search.launches)
    x = torch.randn(16, 256)
    p, w = isax_summarize.summarize(x, znorm=True)
    assert p.shape == (16, 16) and w.dtype == torch.int32
    lb = lb_distance.lb_distance(p, p, p)
    assert lb.shape == (16, 16)
    # the whole refinement over 2 leaves of 8 rows, 2 rounds of 1 leaf
    q = x[:3].contiguous()
    order = torch.tensor([[0, 1]] * 3, dtype=torch.int32)
    d, e, r = refine_search.refine_search(
        q, (q * q).sum(1), x, (x * x).sum(1), order,
        torch.zeros(3, 2), leaf_capacity=8, k=2, round_leaves=1)
    assert d.shape == (3, 2) and r.tolist() == [2, 2, 2]
    assert e[:, 0].tolist() == [0, 1, 2]             # each query is a row
    assert (isax_summarize.launches, lb_distance.launches,
            refine.launches, refine_search.launches) == before


def test_cpu_scan_and_attention_count_nothing():
    before = {name: mod.launches for name, mod in ops.WRAPPERS.items()}
    d, i = ops.ed_argmin(torch.randn(3, 64), torch.randn(10, 64))
    assert d.shape == (3,) and i.dtype == torch.int32
    q = torch.randn(1, 2, 16, 32)
    assert ops.flash_attention(q, q, q).shape == q.shape
    assert ed_argmin.launches == before["ed_argmin"]
    assert flash_attention.launches == before["flash_attention"]
    assert {n: m.launches for n, m in ops.WRAPPERS.items()} == before


def test_dtw_wrappers_raise_on_what_the_kernel_does_not_take():
    q, x = torch.zeros(2, 16), torch.zeros(9, 16)
    lb = torch.zeros(2, 9)
    order = torch.zeros(2, 9, dtype=torch.int64)
    for bad_q, bad_x, err in ((q.double(), x, TypeError),
                              (q, x.bfloat16(), TypeError),
                              (q, torch.zeros(9, 8), ValueError),
                              (q[0], x, ValueError),
                              (q, x.t().contiguous().t(), ValueError),
                              (torch.zeros(2, 1025), torch.zeros(3, 1025),
                               ValueError)):
        for call in (lambda: dtw.lb_keogh(bad_q, bad_x, r=2),
                     lambda: dtw.dtw_scan(bad_q, bad_x, r=2)):
            with pytest.raises(err):
                call()
    for r in (-1, 2.0):
        with pytest.raises(ValueError):
            dtw.lb_keogh(q, x, r=r)
    with pytest.raises(ValueError):
        dtw.dtw_scan(q, x[:0], r=2)                  # no series to scan
    for args, err in (((lb.double(), order), TypeError),
                      ((lb, order.int()), TypeError),
                      ((lb[:, :8], order), ValueError),
                      ((lb.t().contiguous().t(), order), ValueError)):
        with pytest.raises(err):
            dtw.dtw_search(q, x, *args, r=2, round_k=4)
    for rk in (0, 1025):
        with pytest.raises(ValueError):
            dtw.dtw_search(q, x, lb, order, r=2, round_k=rk)
    with pytest.raises(ValueError):                  # band too wide
        dtw.dtw_search(q, x, lb, order, r=900, round_k=32)
    with pytest.raises(RuntimeError, match="meta"):
        dtw.lb_keogh(torch.zeros(2, 16, device="meta"),
                     torch.zeros(9, 16, device="meta"), r=2)


def test_dtw_wrappers_raise_on_a_route_the_shape_does_not_take():
    q, x = torch.zeros(2, 16), torch.zeros(9, 16)
    lb = torch.zeros(2, 9)
    order = torch.zeros(2, 9, dtype=torch.int64)
    for route in ("l256", "band", "fast"):
        with pytest.raises(ValueError, match="routes"):
            dtw.lb_keogh(q, x, r=2, route=route)
    with pytest.raises(ValueError, match="routes"):
        dtw.dtw_search(q, x, lb, order, r=17, round_k=4, route="band")
    with pytest.raises(ValueError, match="routes"):
        dtw.dtw_scan(q, x, r=20, route="band")
    # the general route takes every radius, the band route up to 16
    assert dtw.dtw_scan(q, x, r=2, route="general")[1].tolist() == [0, 0]
    assert dtw.dtw_scan(q, x, r=16, route="band")[1].tolist() == [0, 0]


def test_dtw_cpu_tensors_run_the_plain_version_and_count_nothing():
    from repro_torch.kernels import ref
    before = (dtw.launches, dict(dtw.by_route))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(40, 24, generator=g).cumsum(1)
    q = x[:3] + 0.1
    lb = dtw.lb_keogh(q, x, r=3)
    assert torch.equal(lb, ref.lb_keogh_ref(q, x, 3))
    s, o = torch.sort(lb, dim=1, stable=True)
    got = dtw.dtw_search(q, x, s, o, r=3, round_k=8)
    for a, b in zip(got, ref.dtw_search_ref(q, x, s, o, 3, 8)):
        assert torch.equal(a, b)
    d2, i = dtw.dtw_scan(q, x, r=3)
    assert i.tolist() == got[1].tolist() and torch.equal(d2, got[0])
    assert (dtw.launches, dtw.by_route) == before


def test_loader_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()
    assert not (tmp_path / "build").exists()


def test_library_names_follow_the_sources(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    paths = {n: _build.library_path(n) for n in _build.SOURCES}
    for name, path in paths.items():
        assert path.parent == tmp_path and path.name.startswith(name + "-")
        assert (_build.CSRC / f"{name}.cu").is_file()
    assert len(set(paths.values())) == len(paths)


def test_first_builds_from_many_threads_build_once(monkeypatch, tmp_path):
    """Eight threads ask for a library at once (the index builder's
    Refresh workers launch kernels): the build runs once and every thread
    gets the one loaded library."""
    import threading
    import time
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LOADED", {})
    builds = []

    def fake_build_all():
        builds.append(threading.get_ident())
        time.sleep(0.05)                 # a window for the others to race
        _build.library_path("lb_distance").write_bytes(b"")
        return {}
    monkeypatch.setattr(_build, "build_all", fake_build_all)
    monkeypatch.setattr(_build.ctypes, "PyDLL", lambda path: ("lib", path))
    got = []
    start = threading.Barrier(8)

    def worker():
        start.wait()
        got.append(_build.library("lb_distance"))
    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(builds) == 1 and len(got) == 8
    assert all(g is got[0] for g in got)


def test_build_outputs_are_named_by_process_and_thread(monkeypatch,
                                                       tmp_path):
    """Two builders never write one temporary file: its name carries the
    process and the thread."""
    import threading
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build, "SOURCES", ("lb_distance",))
    seen = []

    class Done:
        returncode = 0

        def __init__(self, cmd, **kw):
            seen.append(cmd[cmd.index("-o") + 1])
            open(seen[-1], "w").close()

        def communicate(self):
            return "", ""
    monkeypatch.setattr(_build.subprocess, "Popen", Done)
    _build.build_all()
    assert seen and f".{os.getpid()}.{threading.get_ident()}.tmp" in seen[0]
    assert _build.library_path("lb_distance").is_file()


def test_importing_the_port_loads_neither_jax_nor_repro():
    mods = ["repro_torch", "repro_torch.api", "repro_torch.convert",
            "repro_torch.analysis", "repro_torch.analysis.hooks",
            "repro_torch.analysis.schedules", "repro_torch.analysis.checker",
            "repro_torch.analysis.buggy",
            "repro_torch.checkpoint", "repro_torch.checkpoint.store",
            "repro_torch.maintenance", "repro_torch.maintenance.tombstones",
            "repro_torch.maintenance.policy",
            "repro_torch.runtime", "repro_torch.runtime.journal",
            "repro_torch.runtime.sharding", "repro_torch.runtime.elastic",
            "repro_torch.launch", "repro_torch.launch.mesh",
            "repro_torch.serve", "repro_torch.serve.batcher",
            "repro_torch.serve.engine", "repro_torch.serve.plan_cache",
            "repro_torch.serve.result_cache",
            "repro_torch.core.builder", "repro_torch.core.refresh",
            "repro_torch.core.traverse", "repro_torch.core.tree",
            "repro_torch.core.baselines", "repro_torch.core.dtw",
            "repro_torch.core", "repro_torch.core.isax",
            "repro_torch.core.index", "repro_torch.core.search",
            "repro_torch.data", "repro_torch.data.synthetic",
            "repro_torch.kernels", "repro_torch.kernels._build",
            "repro_torch.kernels.ref", "repro_torch.kernels.isax_summarize",
            "repro_torch.kernels.lb_distance", "repro_torch.kernels.refine",
            "repro_torch.kernels.refine_search",
            "repro_torch.kernels.ops", "repro_torch.kernels.ed_argmin",
            "repro_torch.kernels.flash_attention",
            "repro_torch.kernels.leaf_stats",
            "repro_torch.kernels.leaf_gather", "repro_torch.kernels.dtw",
            "repro_torch.kernels.autotune",
            "repro_torch.quality", "repro_torch.quality.stop_rules",
            "repro_torch.quality.calibrate"]
    here = {m[len("src/"):-len(".py")].replace("/", ".").replace(
        ".__init__", "")
        for m in _py_files(os.path.join(ROOT, "src", "repro_torch"))}
    assert here == set(mods), "a port module is missing from this list"
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "print(bad)\n")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def _py_files(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(d, f), ROOT)
