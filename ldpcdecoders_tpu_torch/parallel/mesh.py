"""Process meshes for SPMD decoding on ``torch.distributed``.

Counterpart of ``ldpcdecoders_tpu/parallel/mesh.py``.  PyTorch runs one
process (rank) per device, so a mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` over the default process
group, with the reference's axis names: ``("data",)`` shards the syndrome
batch, ``("data", "model")`` also shards the check axis of a large code.
Ranks are laid out row-major over ``shape``, as the reference reshapes its
device list.

A rank computes on ``cuda:{local_rank % device_count}`` (:func:`mesh_device`)
for a mesh built for the card, on the CPU for ``device="cpu"``.  Collective
buffers live where the group's backend wants them: on the card for NCCL, on
the CPU for gloo (:func:`comm_device`), so that a gloo group can also serve
ranks that compute on a card (two ranks on one card, which NCCL refuses).

The reference's ``P``, ``Mesh`` and ``NamedSharding`` are JAX types with no
torch counterpart and are not carried.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["make_mesh", "batch_sharding", "shard_batch", "BatchSharding", "mesh_device",
           "comm_device", "axis_size", "axis_index", "TIMEOUT"]

#: how long a collective waits for its peers before it fails
TIMEOUT = datetime.timedelta(seconds=600)


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def _mesh_device_type(device) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a mesh on the card was requested but torch.cuda.is_available() is False "
            "(pass device='cpu' for a gloo mesh on the CPU)")
    return device


def make_mesh(n_devices: int | None = None, *, axis_names=("data",), shape=None, device=None):
    """A :class:`DeviceMesh` over the ``n_devices`` ranks of the default group.

    Args:
      n_devices: ranks in the mesh (default: the world size, which it must
        equal).
      axis_names: mesh axis names; 1-D ``("data",)`` by default.
      shape: the mesh's shape; defaults to every rank on the first axis.
      device: where the ranks compute: None (the card) or ``"cpu"``.

    With no process group and a world of one (no launcher), a one-rank group
    is set up here from an in-memory store: NCCL on the card, gloo on the
    CPU.  Under a launcher that sets ``WORLD_SIZE`` (``torchrun``) the group
    is set up from its environment.
    """
    device = _mesh_device_type(device)
    if not dist.is_initialized():
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world == 1:
            dist.init_process_group(_backend_for(device), store=dist.HashStore(), rank=0,
                                    world_size=1, timeout=TIMEOUT)
        else:
            dist.init_process_group(_backend_for(device), init_method="env://",
                                    timeout=TIMEOUT)
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"a mesh of {n_devices} ranks was asked for in a world of {world}: "
                         "a mesh spans the whole process group")
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (n_devices,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or int(np.prod(shape)) != n_devices:
        raise ValueError(f"mesh shape {shape} does not lay out {n_devices} ranks over "
                         f"the axes {axis_names}")
    if device.type == "cuda":
        torch.cuda.set_device(_local_rank() % torch.cuda.device_count())
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device.type, shape, mesh_dim_names=axis_names)


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on: ``cuda:{local_rank % device_count}``
    for a mesh on the card, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", _local_rank() % torch.cuda.device_count())
    return torch.device("cpu")


def comm_device(group=None) -> torch.device:
    """Where the buffers of ``group``'s collectives live: the current card
    for NCCL, the CPU for the other backends (gloo)."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis`` (1 for an axis the mesh does not have)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 for an absent axis)."""
    names = mesh.mesh_dim_names or ()
    return mesh.get_local_rank(axis) if axis in names else 0


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """This rank's part of a batch split over a mesh axis: part ``index`` of
    ``parts`` equal parts of the leading axis of an ``ndim``-d array."""

    axis: str
    index: int
    parts: int
    ndim: int

    def bounds(self, batch: int) -> slice:
        """The rows of a batch of ``batch`` this rank holds; raises on a
        batch the axis does not divide."""
        if batch % self.parts:
            raise ValueError(
                f"batch {batch} must divide the '{self.axis}' mesh size {self.parts}")
        b = batch // self.parts
        return slice(self.index * b, (self.index + 1) * b)


def batch_sharding(mesh, ndim: int, data_axis: str = "data") -> BatchSharding:
    """The rank's slice of the leading (batch) axis along ``data_axis``."""
    return BatchSharding(data_axis, axis_index(mesh, data_axis), axis_size(mesh, data_axis),
                         int(ndim))


def shard_batch(arr, mesh, data_axis: str = "data") -> torch.Tensor:
    """This rank's slice of ``arr``'s leading axis, as a tensor on the rank's
    device (:func:`mesh_device`)."""
    if not isinstance(arr, torch.Tensor):
        arr = torch.as_tensor(np.asarray(arr))
    rows = batch_sharding(mesh, arr.ndim, data_axis).bounds(arr.shape[0])
    return arr[rows].to(mesh_device(mesh))
