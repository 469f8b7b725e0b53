"""repro's package-level names on the port: every name that
`repro.core`, `repro.quality` and `repro.checkpoint` export from their
`__init__` imports from the same package of repro_torch (but the names
that are submodules there: `core.search`, `core.isax`,
`quality.calibrate`), and the pure plans `search_plan` and
`snapshot_search` give repro's (dist, ids, rounds) on the same index
(ids and rounds equal, distances at rtol 1e-5, as
tests/test_torch_search.py holds the port's search)."""

import ast
import importlib
import importlib.util
import inspect
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import FreshIndex as JFreshIndex
from repro.api import IndexConfig as JIndexConfig
from repro_torch import convert
from repro_torch.data.synthetic import query_workload, random_walk

torch.set_num_threads(2)

SUBMODULES = {"core": {"search", "isax"}, "quality": {"calibrate"},
              "checkpoint": set()}


def _exported(package: str) -> list:
    """The names repro's `package/__init__.py` imports from its modules
    (its `from .x import ...` lines), as that file lists them."""
    path = Path(importlib.util.find_spec(f"repro.{package}").origin)
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            names += [a.asname or a.name for a in node.names]
    return names


@pytest.mark.parametrize("package", sorted(SUBMODULES))
def test_every_package_level_name_of_repro_imports_from_the_port(package):
    names = _exported(package)
    assert names, package
    port = importlib.import_module(f"repro_torch.{package}")
    for name in names:
        got = getattr(port, name)
        if name in SUBMODULES[package]:
            assert inspect.ismodule(got), name
            assert got.__name__ == f"repro_torch.{package}.{name}"
        else:
            assert not inspect.ismodule(got), name
            assert got.__module__.startswith("repro_torch."), name
        assert name in dir(port)
    # a line of `from ... import ...` answers too
    exec(f"from repro_torch.{package} import {', '.join(names)}", {})


def test_the_readme_lines_import():
    from repro_torch.core import (FlatIndex, build_index,  # noqa: F401
                                  run_search, search_dtw)
    from repro_torch.quality import EXACT, StopRule  # noqa: F401
    from repro_torch.checkpoint import save_checkpoint  # noqa: F401
    from repro_torch.core import search, isax
    from repro_torch.quality import calibrate
    assert all(map(inspect.ismodule, (search, isax, calibrate)))
    with pytest.raises(ImportError):
        exec("from repro_torch.core import no_such_name", {})
    import repro_torch.kernels as kernels
    assert not [n for n in vars(kernels) if not n.startswith("_")
                and not inspect.ismodule(getattr(kernels, n))]


@pytest.fixture(scope="module")
def index():
    walks = random_walk(900, 128, seed=26)
    queries = query_workload(walks, 6, noise_sigma=0.05, seed=27)
    jix = JFreshIndex.build(walks, JIndexConfig(leaf_capacity=32,
                                                backend="pallas"))
    tidx = convert.flat_index_from_numpy(
        {f: np.asarray(getattr(jix.index, f)) for f in jix.index._fields},
        "cpu")
    return jix.index, tidx, walks, queries


@pytest.mark.parametrize("k", [1, 5])
def test_search_plan_equals_repros(index, k):
    from repro.core import search_plan as jplan
    from repro_torch.core import search_plan
    jidx, tidx, _, queries = index
    dj, ij, rj = jplan(jidx, jnp.asarray(queries), k=k, round_leaves=8,
                       backend="pallas")
    for backend in ("ref", "pallas"):
        dt, it, rt = search_plan(tidx, torch.from_numpy(queries), k=k,
                                 round_leaves=8, backend=backend,
                                 dma_depth=2, block_q=4)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5)
        assert rt == int(rj)
    with pytest.raises(ValueError, match="backend"):
        search_plan(tidx, torch.from_numpy(queries), k=k, backend="tpu")


@pytest.mark.parametrize("k", [1, 5])
def test_snapshot_search_equals_repros(index, k):
    from repro.core import snapshot_search as jsnap
    from repro_torch.core import snapshot_search
    jidx, tidx, walks, queries = index
    delta = random_walk(40, 128, seed=28)
    alive = np.ones(40, bool)
    alive[::7] = False
    n_base = len(walks)
    dj, ij, rj = jsnap(jidx, jnp.asarray(delta), jnp.asarray(queries),
                       jnp.asarray(alive), k=k, n_base=n_base,
                       round_leaves=8, backend="pallas")
    dt, it, rt = snapshot_search(tidx, torch.from_numpy(delta),
                                 torch.from_numpy(queries),
                                 torch.from_numpy(alive), k=k,
                                 n_base=n_base, round_leaves=8,
                                 backend="pallas")
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5)
    assert rt == int(rj)
