"""Distributed bundle adjustment: the landmark-sharded Schur reduction
(``parallel/ba.py`` of the JAX package).

* Landmarks and their observations are sharded over the mesh axis; camera
  poses are replicated (keyframe windows are small).
* Each rank linearises its own observations and builds its landmark
  blocks; the camera-space sums (the reduced camera system S and its
  right-hand side for the dense solver, every camera-space partial sum of
  the Schur PCG) and the robust cost are ``all_reduce``d over the ranks
  (``comm.all_reduce_sum``, the counterpart of ``psum``).
* The camera solve then runs replicated, the same bits on every rank;
  landmark back-substitution is local.

The solvers are the single-device ones (``sfm/ba.py``'s ``_solve_step``
and ``lm_loop``, ``sfm/ba_cg.py``'s ``_schur_pcg_step``) with the
all-reduce passed in as ``reduce_fn``: the same LM loop and accept rule,
and the same sorted segment sums (no float atomics), so a rerun gives the
same bits and one rank gives the single-device solvers' bits (a one-rank
all-reduce is a copy).

Use :func:`partition_by_landmark` to lay a global ``BAProblem`` out in
shards (host numpy, the JAX package's layout bit for bit).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch.distributed as dist

from ..config import BAConfig
from ..sfm.ba import BAProblem, _solve_step, ba_cost, block_segments, lm_loop
from ..sfm.ba_cg import _schur_pcg_step, build_obs_layout
from ..utils.precision import f32, resolve_device, state_to
from .comm import all_gather_rows, all_reduce_sum


class ShardedBAProblem(NamedTuple):
    """A ``BAProblem`` in landmark-sharded layout.

    ``landmarks`` (L_pad, 3) and the observation rows (n * O_per) are laid
    out shard after shard; every observation lies in the shard of its
    landmark, with ``obs_lm`` holding the landmark's index in its shard.
    Cameras are replicated."""

    poses: np.ndarray        # (C, 3, 4)
    landmarks: np.ndarray    # (L_pad, 3) by shard
    intrinsics: np.ndarray   # (4,)
    obs_uv: np.ndarray       # (n * O_per, 2) by shard
    obs_cam: np.ndarray      # (n * O_per,) global camera ids
    obs_lm: np.ndarray       # (n * O_per,) landmark ids within the shard
    obs_valid: np.ndarray    # (n * O_per,)
    pose_fixed: np.ndarray   # (C,)


def partition_by_landmark(problem: BAProblem, n_shards: int) -> ShardedBAProblem:
    """Host-side re-layout: landmarks in contiguous blocks over the shards,
    observations routed to their landmark's shard, sorted by (camera,
    landmark within the shard) and padded to one length with invalid rows."""
    L = problem.landmarks.shape[0]
    l_pad = -(-L // n_shards) * n_shards
    lm = np.pad(np.asarray(problem.landmarks, np.float32), ((0, l_pad - L), (0, 0)))
    l_per = l_pad // n_shards

    obs_uv = np.asarray(problem.obs_uv)
    obs_cam = np.asarray(problem.obs_cam)
    obs_lm = np.asarray(problem.obs_lm)
    obs_valid = np.asarray(problem.obs_valid)

    shard_of = obs_lm // l_per
    local_lm = obs_lm % l_per
    per_shard = [np.nonzero(obs_valid & (shard_of == s))[0] for s in range(n_shards)]
    o_per = max(max((len(ix) for ix in per_shard), default=1), 1)

    uv = np.zeros((n_shards, o_per, 2), np.float32)
    cam = np.zeros((n_shards, o_per), np.int32)
    lml = np.zeros((n_shards, o_per), np.int32)
    val = np.zeros((n_shards, o_per), bool)
    for s, ix in enumerate(per_shard):
        ix = ix[np.lexsort((local_lm[ix], obs_cam[ix]))]
        n = len(ix)
        uv[s, :n] = obs_uv[ix]
        cam[s, :n] = obs_cam[ix]
        lml[s, :n] = local_lm[ix]
        val[s, :n] = True
    return ShardedBAProblem(
        poses=np.asarray(problem.poses, np.float32), landmarks=lm,
        intrinsics=np.asarray(problem.intrinsics, np.float32),
        obs_uv=uv.reshape(n_shards * o_per, 2), obs_cam=cam.reshape(-1),
        obs_lm=lml.reshape(-1), obs_valid=val.reshape(-1),
        pose_fixed=np.asarray(problem.pose_fixed, bool))


def _local(sharded: ShardedBAProblem, group, device) -> BAProblem:
    """This rank's shard as a ``BAProblem`` on ``device``."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    l_per = sharded.landmarks.shape[0] // n
    o_per = sharded.obs_uv.shape[0] // n
    lm, ob = slice(me * l_per, (me + 1) * l_per), slice(me * o_per, (me + 1) * o_per)
    return state_to(BAProblem(
        sharded.poses, sharded.landmarks[lm], sharded.intrinsics, sharded.obs_uv[ob],
        sharded.obs_cam[ob], sharded.obs_lm[ob], sharded.obs_valid[ob], sharded.pose_fixed),
        device)


def _solve(sharded: ShardedBAProblem, mesh, config: BAConfig, axis: str, cg: bool):
    group = mesh.get_group(axis)
    local = _local(sharded, group, resolve_device(mesh.device_type))
    reduce = lambda t: all_reduce_sum(t, group)   # noqa: E731
    init_cost = reduce(ba_cost(local, config.huber_delta))
    if cg:
        lay = build_obs_layout(local.obs_cam, local.obs_lm, local.poses.shape[0],
                               local.landmarks.shape[0])
        o = lay.order_lm
        local = local._replace(obs_uv=local.obs_uv[o], obs_cam=lay.cam_sorted,
                               obs_lm=lay.lm_sorted, obs_valid=local.obs_valid[o])
        step = lambda p, lam: _schur_pcg_step(p, lay, lam, config, reduce_fn=reduce)  # noqa: E731
    else:
        segs = block_segments(local)
        step = lambda p, lam: _solve_step(p, lam, config, segs, reduce)  # noqa: E731
    solved, stats = lm_loop(local, init_cost, config, step, reduce)
    return sharded._replace(poses=solved.poses,
                            landmarks=all_gather_rows(solved.landmarks, group)), stats


@f32
def distributed_bundle_adjust(sharded: ShardedBAProblem, mesh, config: BAConfig = BAConfig(),
                              axis: str = "kf"):
    """LM bundle adjustment with the dense Schur reduction all-reduced over
    the mesh's ``axis``, on the mesh's device type.  Returns
    (ShardedBAProblem with the solved poses (replicated) and every shard's
    landmarks (gathered), as tensors; BAStats).

    Small meshes only, as in the JAX package: every rank builds its
    O(C * L_local) coupling ``W`` and the all-reduce carries the dense
    (6C)^2 camera system; :func:`distributed_bundle_adjust_cg` carries
    6C floats per CG iteration."""
    return _solve(sharded, mesh, config, axis, cg=False)


@f32
def distributed_bundle_adjust_cg(sharded: ShardedBAProblem, mesh,
                                 config: BAConfig = BAConfig(), axis: str = "kf"):
    """Matrix-free Schur-PCG LM bundle adjustment, landmark-sharded: the
    Schur operator is applied in observation space on each rank and only
    camera-space vectors (C, 6) are all-reduced, one per CG iteration.
    Returns what :func:`distributed_bundle_adjust` returns."""
    return _solve(sharded, mesh, config, axis, cg=True)
