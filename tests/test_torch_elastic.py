"""The port's elastic runtime and meshes against repro's, on the CPU.

tests/test_runtime.py's cases (`plan_mesh_for`, `ElasticController`,
`StragglerMonitor`) run on both packages on the same inputs and must
decide the same; `plan_serving_mesh`, `MeshSpec.make` and the launch
meshes (`make_debug_mesh`, `make_production_mesh`) keep repro's shapes
and axis names over the port's `Mesh`, count only CUDA devices, and
raise where the machine has fewer devices than the shape unless the
slots are named.  The port carries none of repro's TPU constants.
"""

import pytest
import torch

import repro.runtime.elastic as jelastic
import repro_torch.runtime.elastic as telastic
from repro_torch.launch import mesh as tlaunch
from repro_torch.runtime.sharding import Mesh, make_mesh

PACKAGES = {"repro": jelastic, "port": telastic}


@pytest.fixture(params=sorted(PACKAGES))
def el(request):
    return PACKAGES[request.param]


def test_plan_mesh_for_pod_counts(el):
    m1 = el.plan_mesh_for(1)
    assert m1.shape == (16, 16) and m1.axes == ("data", "model")
    m2 = el.plan_mesh_for(2)
    assert m2.shape == (2, 16, 16) and m2.axes == ("pod", "data", "model")
    assert el.plan_mesh_for(3).shape == (3, 16, 16)


@pytest.mark.parametrize("pods", [1, 2, 3, 5])
@pytest.mark.parametrize("chips,model", [(256, 16), (64, 8), (8, 2)])
def test_plan_mesh_for_agrees(pods, chips, model):
    a = jelastic.plan_mesh_for(pods, chips, model)
    b = telastic.plan_mesh_for(pods, chips, model)
    assert (a.shape, a.axes) == (b.shape, b.axes)


def test_elastic_controller_detects_pod_loss(el):
    world = {"pods": 2}
    ctl = el.ElasticController(lambda: world["pods"])
    assert ctl.check() is None
    world["pods"] = 1
    spec = ctl.check()
    assert spec is not None and spec.shape == (16, 16)
    assert ctl.check() is None
    world["pods"] = 2
    assert ctl.check().shape == (2, 16, 16)


def test_elastic_controllers_agree_on_a_schedule():
    schedule = [2, 2, 1, 1, 3, 2, 2, 4, 1]
    out = {}
    for name, el in PACKAGES.items():
        world = {"pods": schedule[0]}
        ctl = el.ElasticController(lambda: world["pods"], chips_per_pod=64,
                                   model_axis=8)
        seen = []
        for pods in schedule[1:]:
            world["pods"] = pods
            spec = ctl.check()
            seen.append(None if spec is None else (spec.shape, spec.axes))
        out[name] = seen
    assert out["repro"] == out["port"]


def test_elastic_controller_total_loss_raises(el):
    world = {"pods": 1}
    ctl = el.ElasticController(lambda: world["pods"])
    world["pods"] = 0
    with pytest.raises(RuntimeError):
        ctl.check()


def test_straggler_monitor_flags_slow_worker(el):
    mon = el.StragglerMonitor(n_workers=4, factor=1.5)
    for _ in range(10):
        for w in range(4):
            mon.record(w, 1.0 if w != 2 else 2.5)
    assert mon.stragglers() == [2]
    assert abs(mon.median() - 1.0) < 0.2


def test_straggler_monitor_recovers(el):
    mon = el.StragglerMonitor(n_workers=2, factor=1.5, alpha=0.9)
    mon.record(0, 1.0)
    mon.record(1, 5.0)
    assert mon.stragglers() == [1]
    for _ in range(6):
        mon.record(1, 1.0)
    assert mon.stragglers() == []


def test_straggler_monitors_agree_on_a_trace():
    rng = torch.Generator().manual_seed(3)
    times = torch.rand(40, 5, generator=rng).tolist()
    mons = {n: el.StragglerMonitor(n_workers=5, factor=1.2, alpha=0.4)
            for n, el in PACKAGES.items()}
    for step in times:
        for w, t in enumerate(step):
            t = t * (3.0 if w == 4 else 1.0)
            for mon in mons.values():
                mon.record(w, t)
        assert mons["repro"].stragglers() == mons["port"].stragglers()
        assert mons["repro"].median() == mons["port"].median()
    assert 4 in mons["port"].stragglers()


def test_plan_serving_mesh_counts_cards_only():
    spec = telastic.plan_serving_mesh(3, axis="rows")
    assert (spec.shape, spec.axes) == ((3,), ("rows",))
    j = jelastic.plan_serving_mesh(3, axis="rows")
    assert (j.shape, j.axes) == (spec.shape, spec.axes)
    for el in PACKAGES.values():
        with pytest.raises(RuntimeError, match="no healthy devices"):
            el.plan_serving_mesh(0)
    if not torch.cuda.is_available():
        # CPU threads are not devices: nothing to serve from
        with pytest.raises(RuntimeError, match="no healthy devices"):
            telastic.plan_serving_mesh()
    mesh = make_mesh(spec.shape, spec.axes, ["cpu"] * 3)
    assert isinstance(mesh, Mesh) and mesh.shape == {"rows": 3}
    assert mesh.devices == (torch.device("cpu"),) * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA devices"):
            spec.make()


def test_launch_meshes_keep_repro_shapes():
    dbg = tlaunch.make_debug_mesh(devices=["cpu"] * 4)
    assert dbg.axis_names == ("data", "model") and dbg.axis_sizes == (2, 2)
    pod = tlaunch.make_debug_mesh(2, 2, pod=2, devices=["cpu"] * 8)
    assert pod.shape == {"pod": 2, "data": 2, "model": 2}
    prod = tlaunch.make_production_mesh(devices=["cpu"] * 256)
    assert prod.shape == {"data": 16, "model": 16}
    two = tlaunch.make_production_mesh(multi_pod=True,
                                       devices=["cpu"] * 512)
    assert two.shape == {"pod": 2, "data": 16, "model": 16}
    # the slots along one axis, the others at index 0
    m = make_mesh((2, 3), ("data", "model"),
                  ["cpu"] * 5 + ["meta"])
    assert m.axis_devices("data") == (torch.device("cpu"),) * 2
    assert m.axis_devices("model") == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError):
        m.axis_devices("pod")


def test_launch_meshes_need_the_devices():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have >= 4:
        pytest.skip("this machine has the devices of a 2 x 2 mesh")
    with pytest.raises(RuntimeError, match="CUDA devices"):
        tlaunch.make_debug_mesh()
    with pytest.raises(RuntimeError, match="CUDA devices"):
        tlaunch.make_production_mesh()


def test_no_tpu_constants_in_the_port():
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "ICI_BW"):
        assert not hasattr(tlaunch, name)
