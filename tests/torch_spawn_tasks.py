"""Tasks that the port's multi-device tests run on every rank of a
spawned process group (``niftymatch_torch.parallel.spawn.run``).

A spawned child imports the module that holds its task, so the tasks live
here, in a module that imports no JAX, and not in the test files.
Results come back as CPU tensors or plain values.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import torch
import torch.distributed as dist


def _cpu(t):
    return None if t is None else t.cpu()


def mesh_task():
    """The mesh and multihost helpers on this rank: sizes, names, the
    over-request error, this rank's batch slice, and one ring shift,
    all-reduce and all-gather over the kf axis."""
    from niftymatch_torch.parallel import (
        local_batch_slice,
        make_hierarchical_mesh,
        make_keyframe_mesh,
    )
    from niftymatch_torch.parallel.comm import all_gather_rows, all_reduce_sum, ring_shift

    out = {"rank": dist.get_rank(), "world": dist.get_world_size()}
    mesh = make_keyframe_mesh(device_type="cpu")
    out["kf_size"] = mesh.size()
    out["kf_names"] = mesh.mesh_dim_names
    try:
        make_keyframe_mesh(dist.get_world_size() + 1, device_type="cpu")
        out["over_request"] = None
    except ValueError as e:
        out["over_request"] = str(e)
    out["slice"] = local_batch_slice(16)
    h = make_hierarchical_mesh(host_axis="host", device_type="cpu")
    out["hier_shape"] = tuple(h.mesh.shape)
    out["hier_names"] = h.mesh_dim_names
    out["hier_kf_group"] = sorted(dist.get_process_group_ranks(h.get_group("kf")))
    out["local_world_size"] = os.environ.get("LOCAL_WORLD_SIZE")
    group = mesh.get_group("kf")
    out["shifted"] = ring_shift(torch.full((3,), float(dist.get_rank())), group).tolist()
    out["summed"] = all_reduce_sum(torch.ones(2), group).tolist()
    out["gathered"] = all_gather_rows(torch.tensor([[dist.get_rank()]]), group).ravel().tolist()
    return out


def ring_task(inputs, runs):
    """``ring_allpairs_match`` on a CPU mesh, each rank passing its rows
    (``ring_rows``) of every (desc, valid) of ``inputs``, for every keyword
    set of ``runs``: {(input, run): (counts, indices)}; under "rows" each
    input's ``ring_rows``, and under "whole" the error a rank gets for
    passing the whole of the last input (None for none)."""
    from niftymatch_torch.parallel import make_keyframe_mesh, ring_allpairs_match, ring_rows

    mesh = make_keyframe_mesh(device_type="cpu")
    out = {}
    for a, (desc, valid) in enumerate(inputs):
        rows = ring_rows(len(desc), mesh)
        for b, kw in enumerate(runs):
            r = ring_allpairs_match(torch.as_tensor(desc[rows]), torch.as_tensor(valid[rows]),
                                    mesh, num_frames=len(desc), **kw)
            out[a, b] = (_cpu(r.counts), _cpu(r.indices))
    out["rows"] = [ring_rows(len(desc), mesh) for desc, _ in inputs]
    try:
        ring_allpairs_match(torch.as_tensor(desc), torch.as_tensor(valid), mesh,
                            num_frames=len(desc))
        out["whole"] = None
    except ValueError as e:
        out["whole"] = str(e)
    return out


def detect_task(frames, sift_config):
    """``shard_detect`` of ``detect_and_describe_batch`` on a CPU mesh:
    this rank's rows and the gathered features."""
    from niftymatch_torch.parallel import gather_features, make_keyframe_mesh, shard_detect
    from niftymatch_torch.sift import detect_and_describe_batch

    mesh = make_keyframe_mesh(device_type="cpu")
    mine = shard_detect(lambda x: detect_and_describe_batch(x, sift_config, device="cpu"),
                        torch.as_tensor(frames), mesh)
    return mine, gather_features(mine, mesh)


def ba_task(sharded, ba_config):
    """Dense and CG distributed BA on a CPU mesh: {"dense"|"cg": (poses,
    landmarks, BAStats)}."""
    from niftymatch_torch.parallel import (
        distributed_bundle_adjust,
        distributed_bundle_adjust_cg,
        make_keyframe_mesh,
    )

    mesh = make_keyframe_mesh(device_type="cpu")
    out = {}
    for name, solve in (("dense", distributed_bundle_adjust),
                        ("cg", distributed_bundle_adjust_cg)):
        solved, stats = solve(sharded, mesh, ba_config)
        out[name] = (solved.poses, solved.landmarks, stats)
    return out


def sweep_task(desc, valid):
    """The loop closer's candidate sweep (``LoopCloser.sweep``) over a
    store holding ``desc``/``valid``: its (K, K) counts."""
    from niftymatch_torch.slam.closure import LoopCloser

    buf = SimpleNamespace(desc=torch.as_tensor(desc), valid=torch.as_tensor(valid))
    system = SimpleNamespace(keyframes=[None] * buf.desc.shape[0],
                             _store=SimpleNamespace(view=lambda: buf))
    return LoopCloser(system).sweep().counts
