"""Full-trajectory (global) bundle adjustment for the SLAM system
(``slam/globalba.py`` of the JAX package).

The per-frame loop only solves the trailing window
(``SlamSystem.run_windowed_ba``); this is the finalisation pass.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import BAConfig
from ..sfm.ba import BAProblem, bundle_adjust
from ..sfm.ba_cg import bundle_adjust_cg
from ..utils.precision import host_fetch


def run_global_ba(
    system,
    ba_config: BAConfig | None = None,
    use_cg: bool | None = None,
    max_landmarks: int | None = None,
) -> bool:
    """Bundle adjustment over ALL keyframes and their tracks.

    Solver: the dense Schur solver, or the matrix-free Schur-PCG
    (``sfm.ba_cg``) when the dense (C, L, 6, 3) coupling block would pass
    2^27 floats.  Observations and landmarks are padded to power-of-two
    buckets, as in the JAX package (where that reuses its compiles).  One
    solve and one fetch; the result is applied only if it does not raise
    the robust cost.  Returns True when applied; ``system.last_gba`` holds
    the solver that ran and its initial and final costs."""
    system.flush_ba()
    K = len(system.keyframes)
    if K < 3:
        return False
    cfg = system.config
    ids = np.stack([kf.track_ids for kf in system.keyframes])  # (K, N)
    has = ids >= 0
    if not has.any():
        return False
    counts = np.bincount(ids[has], minlength=system.track_positions.shape[0])
    # Leave out tracks culled as outliers during tracking: their stale
    # positions can degrade the solve even when the cost still drops.
    active = np.nonzero((counts >= 2) & system.track_alive)[0]
    if len(active) < 8:
        return False
    if max_landmarks is not None and len(active) > max_landmarks:
        order = np.argsort(-counts[active], kind="stable")
        active = np.sort(active[order[:max_landmarks]])
    lmap = np.full(system.track_positions.shape[0], -1, np.int64)
    lmap[active] = np.arange(len(active))
    for kf in system.keyframes:
        kf.ensure_host_coords()
    xs = np.stack([kf.host_x for kf in system.keyframes])
    ys = np.stack([kf.host_y for kf in system.keyframes])
    local = np.where(has, lmap[np.maximum(ids, 0)], -1)
    ci, si = np.nonzero(local >= 0)
    O, L = len(ci), len(active)
    if O < 16:
        return False
    O_cap = 1 << int(np.ceil(np.log2(max(O, 1024))))
    L_cap = 1 << int(np.ceil(np.log2(max(L, 256))))
    obs_uv = np.zeros((O_cap, 2), np.float32)
    obs_uv[:O, 0] = xs[ci, si]
    obs_uv[:O, 1] = ys[ci, si]
    obs_cam = np.zeros(O_cap, np.int32)
    obs_cam[:O] = ci
    obs_lm = np.zeros(O_cap, np.int32)
    obs_lm[:O] = local[ci, si]
    valid = np.zeros(O_cap, bool)
    valid[:O] = True
    lms = np.zeros((L_cap, 3), np.float32)
    lms[:L] = system.track_positions[active]
    fixed = np.zeros(K, bool)
    fixed[: min(2, K)] = True  # pin the 7-DoF monocular gauge
    problem = BAProblem(
        poses=torch.stack([kf.pose for kf in system.keyframes]),
        landmarks=lms,
        intrinsics=np.asarray(cfg.intrinsics, np.float32),
        obs_uv=obs_uv,
        obs_cam=obs_cam,
        obs_lm=obs_lm,
        obs_valid=valid,
        pose_fixed=fixed,
    )
    ba_cfg = ba_config or dataclasses.replace(cfg.ba, max_iterations=12)
    if use_cg is None:
        use_cg = K * L_cap * 18 > (1 << 27)
    solver = bundle_adjust_cg if use_cg else bundle_adjust
    solved, stats = solver(problem, ba_cfg, device=system.device)
    lms_h, c0, c1 = host_fetch(solved.landmarks, stats.initial_cost, stats.final_cost)
    system.last_gba = {"solver": "cg" if use_cg else "dense",
                       "initial_cost": float(c0), "final_cost": float(c1)}
    if not (float(c1) <= float(c0)):
        return False
    # Loop-edge consistency guard (the JAX package's round 5): accepted
    # loop closures are measurements independent of the reprojection
    # problem; a solve that lowers the robust cost while blowing up the
    # loop edges' relative-pose residuals is re-fitting observation noise
    # at the expense of global structure.  Tripping demands recovery:
    # re-run loop closure against the refined map, and roll the whole
    # round back only if re-closure cannot re-apply an accepted edge set.
    closer = getattr(system, "closer", None)
    guard = None
    if closer is not None and closer.last_loop_edges is not None:
        (poses_h,) = host_fetch(solved.poses)
        before = closer.loop_edge_consistency(system.poses())
        after = closer.loop_edge_consistency(poses_h[:K])
        guard = {
            "edge_consistency_before": before,
            "edge_consistency_after": after,
            "tripped": bool(before is not None and after is not None
                            and after > max(3.0 * before, 0.01)),
        }
    if guard is not None and guard["tripped"]:
        snap = closer.snapshot_map()
        for k, kf in enumerate(system.keyframes):
            kf.pose = solved.poses[k]
        system.track_positions[active] = lms_h[:L]
        reapplied = int(system.close_loops())
        guard["reclosure_edges"] = reapplied
        if reapplied <= 0:
            closer.restore_map(snap)
            guard["rolled_back"] = True
            system.last_gba_guard = guard
            return False
        guard["rolled_back"] = False
        system.last_gba_guard = guard
        return True
    system.last_gba_guard = guard
    for k, kf in enumerate(system.keyframes):
        kf.pose = solved.poses[k]
    system.track_positions[active] = lms_h[:L]
    return True
