"""Multi-process set-up and reduced statistics of sharded FER work.

Counterpart of ``ldpcdecoders_tpu/parallel/multihost.py`` on
``torch.distributed``: a process group over a TCP rendezvous, a mesh over
the whole world, summed integer counts and rank 0's state sent to every
rank.  A single process (no group, or a world of one) passes through: the
reductions are the identity.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .mesh import TIMEOUT, comm_device, make_mesh

__all__ = [
    "initialize_multihost",
    "global_mesh",
    "allreduce_counts",
    "broadcast_from_host0",
    "world",
]


def world() -> tuple[int, int]:
    """``(processes, this process's rank)``: ``(1, 0)`` without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def initialize_multihost(coordinator: str | None = None, num_processes: int | None = None,
                         process_id: int | None = None, *, backend: str | None = None):
    """Join a process group of ``num_processes`` ranks at ``coordinator``
    (``host:port``, where rank 0 listens).

    A no-op without a coordinator and a process count (a single process, or
    a launcher that sets the group up itself), and where the group is
    already set up.  ``backend``: NCCL where a CUDA card is present, else
    gloo.  :data:`.mesh.TIMEOUT` bounds the rendezvous and every collective,
    so that a lost peer fails the call instead of hanging it.
    """
    if coordinator is None and num_processes is None:
        return
    if dist.is_initialized():
        return  # set up by a launcher or an earlier call
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=TIMEOUT)


def global_mesh(axis_name: str = "data", *, device=None):
    """1-D mesh over every rank of the world (see :func:`.mesh.make_mesh`
    for ``device``)."""
    return make_mesh(axis_names=(axis_name,), device=device)


def allreduce_counts(local_counts: dict, mesh=None) -> dict:
    """Sum integer statistic dicts over every process.

    Each process passes its local ``{"trials": t, "failures": f, ...}`` and
    receives the global totals: one ``all_reduce(SUM)`` of an int64 vector
    (the reference sums float64 and rounds, the same integers below 2**53).
    ``mesh`` is accepted for the reference's signature; the sum runs over
    the whole world.  With one process this is the identity.
    """
    keys = sorted(local_counts)
    procs, _ = world()
    if procs == 1:
        return {k: int(local_counts[k]) for k in keys}
    vec = torch.tensor([int(local_counts[k]) for k in keys], dtype=torch.int64,
                       device=comm_device())
    dist.all_reduce(vec)
    return {k: int(v) for k, v in zip(keys, vec.cpu().tolist())}


def broadcast_from_host0(vec: np.ndarray) -> np.ndarray:
    """Every process's array replaced by process 0's copy (float64).

    Resumed FER-sweep state: only process 0 writes checkpoints, so only its
    loaded state is authoritative.  With one process this is the identity.
    """
    procs, _ = world()
    if procs == 1:
        return np.asarray(vec)
    t = torch.as_tensor(np.asarray(vec, np.float64)).to(comm_device())
    dist.broadcast(t, src=0)
    return t.cpu().numpy()
