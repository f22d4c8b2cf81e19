"""Keyframe mesh construction (``parallel/mesh.py`` of the JAX package).

The workload scales over keyframes, so the canonical mesh is 1-D over a
``kf`` axis of the initialised process group (``torch.distributed``, one
rank per device; see ``multihost.initialize_distributed``).
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def make_keyframe_mesh(n_devices: int | None = None, axis_name: str = "kf",
                       device_type: str = "cuda") -> DeviceMesh:
    """1-D ``DeviceMesh`` over the first ``n_devices`` ranks of the process
    group (all of them for None), on ``device_type`` ("cuda" unless the
    caller asks for "cpu").  Asking for more ranks than the group has
    raises: a silently smaller mesh would fake scaling results."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call multihost.initialize_distributed first")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(f"requested a {n}-rank mesh but the process group has {world} "
                         f"ranks: a silently smaller mesh would fake scaling results")
    return DeviceMesh(device_type, list(range(n)), mesh_dim_names=(axis_name,))
