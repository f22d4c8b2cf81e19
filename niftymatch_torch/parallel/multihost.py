"""Process-group initialisation and mesh layout helpers
(``parallel/multihost.py`` of the JAX package).

``jax.distributed.initialize`` becomes ``torch.distributed``'s
``init_process_group``, one process per device.  Nothing here finds a
cluster by itself: the caller gives the rendezvous address (``tcp://`` or
``file://``), the process count and this process's rank.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None) -> None:
    """Join the process group; a no-op for one process with no address.

    ``backend`` defaults to NCCL where CUDA is available and gloo
    elsewhere; pass it to choose otherwise (gloo with CUDA tensors stages
    every transfer through the host, see ``comm``)."""
    if not (num_processes is not None and num_processes > 1 or coordinator_address):
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes or 1, rank=process_id or 0)


def make_hierarchical_mesh(kf_axis: str = "kf", host_axis: str | None = None,
                           device_type: str = "cuda") -> DeviceMesh:
    """Mesh over every rank of the group.  With ``host_axis`` the ranks
    factor as (hosts, ranks per host), so heavy traffic (the ring) can stay
    on the within-host axis.  The ranks per host come from
    ``LOCAL_WORLD_SIZE`` (set by ``torchrun``); without it there is one
    host."""
    world = dist.get_world_size()
    if host_axis is None:
        return DeviceMesh(device_type, list(range(world)), mesh_dim_names=(kf_axis,))
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % per_host:
        raise ValueError(f"{world} ranks do not split into hosts of {per_host}")
    grid = torch.arange(world).reshape(world // per_host, per_host)
    return DeviceMesh(device_type, grid, mesh_dim_names=(host_axis, kf_axis))


def local_batch_slice(global_batch: int) -> slice:
    """Rows of a globally sharded keyframe batch owned by this rank."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    i = dist.get_rank() if dist.is_initialized() else 0
    per = global_batch // n
    return slice(i * per, (i + 1) * per)
