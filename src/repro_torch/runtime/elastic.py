"""Elastic re-meshing and straggler detection.

The port's copy of `repro.runtime.elastic`, over the port's `Mesh`:

  * `plan_mesh_for` picks the largest valid (pod, data, model) mesh for
    the surviving pods, and `ElasticController` re-plans when the pod
    count reported by a `healthy_pods()` callback changes (tests drive
    it with a dict);
  * `plan_serving_mesh` is the serving plane's recovery mesh: one row
    over every card still visible (`QueryEngine.recover` uses it when a
    sharded index is recovered without an explicit mesh);
  * `StragglerMonitor` keeps an EWMA of each worker's step time and
    flags those above `factor` x the fleet median.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch

from .sharding import Mesh, make_mesh


@dataclass
class MeshSpec:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    def make(self) -> Mesh:
        """The port's Mesh of this shape over the first CUDA devices
        (`make_mesh`)."""
        return make_mesh(self.shape, self.axes)


def plan_mesh_for(n_pods: int, chips_per_pod: int = 256,
                  model_axis: int = 16) -> MeshSpec:
    """Largest valid mesh for the surviving pods."""
    assert n_pods >= 1
    data = chips_per_pod // model_axis
    if n_pods == 1:
        return MeshSpec((data, model_axis), ("data", "model"))
    return MeshSpec((n_pods, data, model_axis), ("pod", "data", "model"))


def plan_serving_mesh(n_devices: Optional[int] = None,
                      axis: str = "data") -> MeshSpec:
    """Largest 1-D query mesh over the surviving devices: `n_devices`,
    or, when None, the CUDA devices visible (`torch.cuda.device_count()`;
    CPU threads are never counted as devices, so a CPU caller passes
    `n_devices` or a mesh).  Raises RuntimeError when none is left."""
    if n_devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    else:
        n = int(n_devices)
    if n < 1:
        raise RuntimeError("no healthy devices left to serve from")
    return MeshSpec((n,), (axis,))


class ElasticController:
    """Decides when to re-mesh; owns the resume-from-checkpoint flow."""

    def __init__(self, healthy_pods: Callable[[], int],
                 chips_per_pod: int = 256, model_axis: int = 16):
        self.healthy_pods = healthy_pods
        self.chips_per_pod = chips_per_pod
        self.model_axis = model_axis
        self.current_pods = healthy_pods()

    def check(self) -> Optional[MeshSpec]:
        """Returns a new MeshSpec if the world changed, else None."""
        now = self.healthy_pods()
        if now == self.current_pods:
            return None
        if now < 1:
            raise RuntimeError("no healthy pods left")
        self.current_pods = now
        return plan_mesh_for(now, self.chips_per_pod, self.model_axis)


class StragglerMonitor:
    """EWMA step-time tracker; flags workers slower than factor x median."""

    def __init__(self, n_workers: int, factor: float = 1.5,
                 alpha: float = 0.3):
        self.n = n_workers
        self.factor = factor
        self.alpha = alpha
        self.ewma: List[Optional[float]] = [None] * n_workers

    def record(self, worker: int, step_time: float) -> None:
        e = self.ewma[worker]
        self.ewma[worker] = step_time if e is None else \
            (1 - self.alpha) * e + self.alpha * step_time

    def stragglers(self) -> List[int]:
        vals = [e for e in self.ewma if e is not None]
        if len(vals) < 2:
            return []
        med = statistics.median(vals)
        return [i for i, e in enumerate(self.ewma)
                if e is not None and e > self.factor * med]

    def median(self) -> Optional[float]:
        vals = [e for e in self.ewma if e is not None]
        return statistics.median(vals) if vals else None
