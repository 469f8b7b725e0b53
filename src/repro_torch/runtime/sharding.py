"""The port's mesh: named axes over a flat tuple of device slots.

The counterpart of the jax `Mesh` that `repro` shards its index over.
One Python process drives every slot (repro's `shard_map` is
single-controller too): a slot is a `torch.device`, and slots may repeat
a device, so `make_mesh((4,), ("data",), [cuda:0] * 4)` is a 4-shard
mesh on one card and the same code runs 4 shards on 4 cards where a
machine has them.

    mesh = make_mesh((4,), ("data",))           # cuda:0 .. cuda:3
    mesh.shape["data"]                          # 4
    mesh_sig(mesh)                              # the plan caches' key

`Sharded(mesh, axis)` is a placement that cuts an array's first
dimension into `mesh.shape[axis]` contiguous blocks, block s on slot s
of that axis (`place`); a `torch.device` places it whole.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

import torch

__all__ = ["Mesh", "Sharded", "make_mesh", "mesh_sig", "place"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names, axis sizes and the slots in row-major order (the last
    axis fastest), one `torch.device` a slot; a device may fill several
    slots."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.axis_sizes)} sizes")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis names repeat: {self.axis_names}")
        if any(s < 1 for s in self.axis_sizes):
            raise ValueError(f"axis sizes must be >= 1, got "
                             f"{self.axis_sizes}")
        if len(self.devices) != math.prod(self.axis_sizes):
            raise ValueError(f"a mesh of shape {self.axis_sizes} needs "
                             f"{math.prod(self.axis_sizes)} slots, got "
                             f"{len(self.devices)}")

    @property
    def shape(self) -> dict:
        """{axis name: size}, as a jax mesh's `shape`."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """The number of slots."""
        return len(self.devices)

    def axis_devices(self, axis: str) -> Tuple[torch.device, ...]:
        """The slots along `axis`, every other axis at index 0: where
        block s of an array cut over `axis` lives."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r} (axes "
                             f"{self.axis_names})")
        a = self.axis_names.index(axis)
        stride = math.prod(self.axis_sizes[a + 1:])
        return tuple(self.devices[s * stride]
                     for s in range(self.axis_sizes[a]))


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of `shape` named `axes`.  `devices` gives the slots in
    row-major order (device names or `torch.device`s; repeats allowed);
    None takes the first prod(shape) CUDA devices and raises
    RuntimeError where the machine has fewer."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"a mesh of shape {shape} needs {n} CUDA devices, this "
                f"machine has {have}; pass devices= to name the slots")
        devices = [torch.device("cuda", i) for i in range(n)]
    return Mesh(tuple(axes), shape, tuple(torch.device(d) for d in devices))


def mesh_sig(mesh: Mesh) -> Tuple:
    """Hashable identity of a mesh PLACEMENT: axis names, axis sizes and
    each slot's device as (type, index), in order.  Everything that
    caches per-mesh plans (the facade's `_sharded_fns`, the serving
    `PlanCache`) keys on this, so a re-mesh onto other devices, or onto
    a different number of slots of one device, never reuses a plan made
    for the old placement."""
    return (tuple(mesh.axis_names), tuple(mesh.axis_sizes),
            tuple((d.type, d.index) for d in mesh.devices))


@dataclasses.dataclass(frozen=True)
class Sharded:
    """Placement of an array cut over one mesh axis: its first dimension
    in `mesh.shape[axis]` equal contiguous blocks, block s on slot s."""
    mesh: Mesh
    axis: str = "data"


def place(t: torch.Tensor, placement: Union[Sharded, torch.device, str]):
    """`t` placed as `placement` says: a device -> `t` on it (itself when
    already there); `Sharded` -> a tuple of blocks, each a view of `t`
    where the slot is t's own device and a copy on the slot otherwise.
    Raises ValueError when the first dimension does not divide into the
    axis' size."""
    if not isinstance(placement, Sharded):
        return t.to(torch.device(placement))
    slots = placement.mesh.axis_devices(placement.axis)
    n = t.shape[0]
    if n % len(slots):
        raise ValueError(f"{n} rows do not divide into {len(slots)} "
                         f"blocks over axis {placement.axis!r}")
    b = n // len(slots)
    return tuple(t[s * b:(s + 1) * b].to(dev)
                 for s, dev in enumerate(slots))
