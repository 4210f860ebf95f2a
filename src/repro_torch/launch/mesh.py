"""Mesh constructors of the port, counterparts of ``repro.launch.mesh``.

Topology of the JAX package's production target:
  * single pod: 16 x 16 = 256 chips, axes ("data", "model")
  * multi pod:  2 x 16 x 16 = 512 chips, axes ("pod", "data", "model")

One card cannot hold a device mesh of 256, and the sharding rules read
nothing of a mesh but its axis names and sizes, so
:func:`make_production_mesh` returns an :class:`AbstractMesh` (JAX's
``AbstractMesh`` in kind): names and sizes, no devices.  The dry-run
plans the production cells on it.  :func:`make_host_mesh` returns a live
``torch.distributed`` ``DeviceMesh`` over the local cards (one on an
H100), wrapped as a :class:`HostMesh`.  Both expose ``.shape`` as a
mapping from axis name to size, so ``runtime.sharding.build_rules`` takes
either.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no devices behind it."""
    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


class HostMesh:
    """A live ``DeviceMesh`` over this host's devices, with JAX's
    ``mesh.shape`` (axis name -> size) beside it."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.axis_sizes = tuple(int(s) for s in device_mesh.mesh.shape)
        self.device_type = device_mesh.device_type

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(self.device_mesh.mesh.numel())

    def group(self, axis: str):
        """The process group of one mesh axis."""
        return self.device_mesh.get_group(axis)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def ensure_process_group(device: torch.device) -> None:
    """A default process group for this process, if it has none: NCCL on
    the card, gloo on the CPU, one rank over an in-process store.  A
    caller that runs several ranks initialises its own group first."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_host_mesh(device=None, axes: tuple[str, ...] = ("data",)) \
        -> HostMesh:
    """The local cards as a 1-D ``"data"`` mesh (``axes`` may name more
    axes of size 1, such as ``("data", "model")``); ``device`` resolves as
    every entry point's does (the card unless the CPU is named).  Its
    size is the default process group's world size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch import device as _device
    dev = _device.resolve(device)
    ensure_process_group(dev)
    n = dist.get_world_size()
    shape = (n,) + (1,) * (len(axes) - 1)
    ranks = torch.arange(n).reshape(shape)
    return HostMesh(DeviceMesh(dev.type, ranks, mesh_dim_names=axes))
