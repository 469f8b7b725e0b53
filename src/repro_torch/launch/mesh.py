"""Production and debug meshes, repro's shapes and axis names over the
port's `Mesh`.

Functions, not module constants, so importing this module never queries
the devices.  Without `devices`, each takes the first CUDA devices and
raises RuntimeError where the machine has fewer than the shape needs;
`devices` names the slots (repeats allowed, so a CPU test or one card
can stand in for a pod).
"""

from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.runtime.sharding import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """16x16 single pod (256 devices) or 2x16x16 two pods (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def make_debug_mesh(data: int = 2, model: int = 2, pod: int = 0,
                    devices: Optional[Sequence] = None) -> Mesh:
    """Small mesh for multi-device tests."""
    if pod:
        return make_mesh((pod, data, model), ("pod", "data", "model"),
                         devices)
    return make_mesh((data, model), ("data", "model"), devices)
