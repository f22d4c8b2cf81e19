"""The multi-device dry run, the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``:

    python -m niftymatch_torch.dryrun 4                 # 4 cards (NCCL)
    python -m niftymatch_torch.dryrun 4 --device cpu    # 4 CPU ranks (gloo)

spawns ``n_devices`` ranks (``parallel.spawn``), and on each runs the
sharded multi-keyframe step at tiny shapes: ``shard_detect`` of 2 frames
a rank at 48x64 (32 keypoints a level, 64 features), the ring's all-pairs
counts of the ranks' detected frames and their sum, and ``distributed_bundle_adjust`` for 3 iterations
on ``make_scene(4, 16 * n)`` with landmarks 0.05 off; the final cost must
not exceed the initial one.  Rank 0 prints the JAX package's one-line
summary.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def _step(n_devices: int, device: str):
    """One rank's part of the dry run; returns the summary line."""
    import torch.distributed as dist

    from .config import BAConfig, SiftConfig
    from .data.synthetic import make_observation_table, make_scene
    from .parallel import (
        distributed_bundle_adjust,
        make_keyframe_mesh,
        partition_by_landmark,
        ring_allpairs_match_counts,
        shard_detect,
    )
    from .sfm.ba import BAProblem
    from .sift import detect_and_describe_batch

    dev = torch.device(device)
    mesh = make_keyframe_mesh(n_devices, device_type=dev.type)
    h, w = 48, 64
    k = 2 * n_devices
    cfg = SiftConfig(width=w, height=h, max_keypoints_per_level=32, max_features=64)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.uniform(0, 255, (k, h, w)).astype(np.float32)).to(dev)
    mine = shard_detect(lambda x: detect_and_describe_batch(x, cfg, device=dev), images, mesh)
    counts = ring_allpairs_match_counts(mine.desc, mine.valid, mesh)
    total = int(counts.sum())
    if tuple(counts.shape) != (k, k):
        raise RuntimeError(f"the ring returned counts of shape {tuple(counts.shape)}")

    scene = make_scene(num_cams=4, num_landmarks=16 * n_devices, seed=0)
    obs_uv, obs_cam, obs_lm, valid = make_observation_table(scene, seed=0)
    fixed = np.zeros(4, bool)
    fixed[:2] = True
    problem = BAProblem(scene.poses, scene.landmarks + 0.05, scene.intrinsics, obs_uv,
                        obs_cam, obs_lm, valid, fixed)
    sharded = partition_by_landmark(problem, n_devices)
    _, stats = distributed_bundle_adjust(sharded, mesh, BAConfig(max_iterations=3))
    c0, c1 = float(stats.initial_cost), float(stats.final_cost)
    if not c1 <= c0:
        raise RuntimeError(f"distributed BA raised the cost: {c0} -> {c1}")
    line = (f"dryrun_multichip OK: mesh={{'kf': {mesh.size()}}}, counts {tuple(counts.shape)}, "
            f"total={total}, ba cost {c0:.1f} -> {c1:.3f}")
    if dist.get_rank() == 0:
        print(line, flush=True)
    return line


def dryrun_multichip(n_devices: int, device: str = "cuda") -> str:
    """Spawn ``n_devices`` ranks and run the dry run: on CUDA (NCCL, one
    card a rank) unless the caller asks for the CPU (gloo).  Returns the
    summary line."""
    from .parallel import spawn

    lines = spawn.run(_step, n_devices, n_devices, device, device=device)
    if len(set(lines)) != 1:
        raise RuntimeError(f"the ranks disagree: {lines}")
    return lines[0]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n_devices", type=int)
    parser.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = parser.parse_args()
    dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
