"""Mesh constructors of the port, counterparts of ``repro.launch.mesh``.

Topology of the JAX package's production target:
  * single pod: 16 x 16 = 256 chips, axes ("data", "model")
  * multi pod:  2 x 16 x 16 = 512 chips, axes ("pod", "data", "model")

One card cannot hold a device mesh of 256, and the sharding rules read
nothing of a mesh but its axis names and sizes, so
:func:`make_production_mesh` returns an :class:`AbstractMesh` (JAX's
``AbstractMesh`` in kind): names and sizes, no devices.  The dry-run
plans the production cells on it.  :func:`make_host_mesh` returns a live
``torch.distributed`` ``DeviceMesh`` over the ranks of the process
group (one rank a card under ``torchrun``, or several ranks on one card
over gloo), wrapped as a :class:`HostMesh`.  Both expose ``.shape`` as a
mapping from axis name to size, so ``runtime.sharding.build_rules`` takes
either.
"""
from __future__ import annotations

import dataclasses
import math
import os
import sys

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


def world_size() -> int:
    """The ranks ``torchrun`` started (1 without it)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def quiet_unless_rank0() -> None:
    """Under ``torchrun``, only rank 0 prints: the others' standard output
    goes to the null device."""
    if os.environ.get("RANK", "0") != "0":
        sys.stdout = open(os.devnull, "w")


def local_device(device=None) -> torch.device:
    """This rank's device: the CPU when ``device`` names it, else
    ``cuda:(LOCAL_RANK mod the card count)`` (several ranks share a card
    when there are more ranks than cards)."""
    from repro_torch import device as _device
    dev = _device.resolve(device)
    if dev.type == "cuda" and device in (None, "cuda") \
            and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"])
                           % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def group_backend(device: torch.device, world: int) -> str:
    """NCCL where every rank has a card of its own, else gloo: NCCL
    refuses two ranks on one device, and the CPU has no NCCL."""
    if device.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def ensure_process_group(device: torch.device) -> None:
    """A default process group for this process, if it has none: the group
    that ``torchrun`` or a test's spawner described in ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``, or, with none of
    them set, one rank over an in-process store.  Its backend is
    :func:`group_backend`'s."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    env = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
    if all(k in os.environ for k in env):
        world = int(os.environ["WORLD_SIZE"])
        dist.init_process_group(group_backend(device, world),
                                init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=world)
        return
    dist.init_process_group(group_backend(device, 1),
                            store=dist.HashStore(), rank=0, world_size=1)


def make_host_mesh(device=None, axes: tuple[str, ...] = ("data",),
                   shape: tuple[int, ...] | None = None) -> HostMesh:
    """The ranks of the default process group as a mesh over ``axes``:
    JAX's 1-D ``"data"`` mesh over every rank by default (``axes`` may
    name more axes, of size 1), or ``shape`` (its product the world size),
    such as (2, 2) over ``("data", "model")``.  ``device`` resolves as
    every entry point's does (the card unless the CPU is named; this
    rank's card under ``torchrun``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    dev = local_device(device)
    ensure_process_group(dev)
    n = dist.get_world_size()
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    if len(shape) != len(axes) or math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} over {axes} does not cover "
                         f"{n} ranks")
    ranks = torch.arange(n).reshape(shape)
    return HostMesh(DeviceMesh(dev.type, ranks, mesh_dim_names=axes))
