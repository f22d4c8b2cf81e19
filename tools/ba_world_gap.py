"""How far world 2's PCG bundle adjustment lands from world 1's on phase
7c's problem (512 x 131,072 x 2,097,152), and how far a mere change of
summation order moves world 1, at several LM x CG budgets:

    python3 tools/ba_world_gap.py

For each budget: world 1 on NCCL (this process alone) on the problem and
on the same problem with its landmarks relabelled by a random permutation
(``smoke_parallel.relabelled``: the same solve, every segment sum in
another order), and world 2 on gloo (two spawned processes on
``cuda:0``).  Prints each run's final cost and the largest pose
differences: world 2 and the relabelled run against world 1, and each
against the truth.  Where world 2's gap lies within the relabelled run's,
world 2 differs from world 1 as much as the order of the sums alone
moves a solve.  A reading on the card only.
"""

from __future__ import annotations

import os
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

BUDGETS = ((6, 24), (6, 200), (24, 200))    # (LM iterations, CG iterations a step)


def solve_all(sharded):
    """``distributed_bundle_adjust_cg`` of ``sharded`` at every budget on
    this rank's process group: [(costs, poses)] on the CPU."""
    import niftymatch_torch as nt
    from niftymatch_torch.parallel import distributed_bundle_adjust_cg, make_keyframe_mesh

    mesh = make_keyframe_mesh()
    out = []
    for lm, cg in BUDGETS:
        cfg = nt.BAConfig(max_iterations=lm, damping=1e-3, cg_iterations=cg)
        solved, stats = distributed_bundle_adjust_cg(sharded, mesh, cfg)
        out.append((stats.costs.cpu(), solved.poses.cpu()))
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import chip_smoke
    import torch.distributed as dist
    from niftymatch_torch.parallel import initialize_distributed, partition_by_landmark, spawn
    from niftymatch_torch.utils.smoke_parallel import relabelled
    from niftymatch_torch.utils.smoke_sfm import global_problem

    print(f"[gap] {chip_smoke.card_line()}")
    scene, problem = global_problem()
    truth = torch.from_numpy(scene.poses)
    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed(f"file://{os.path.join(tmp, 'rendezvous')}", 1, 0, "nccl")
        try:
            w1 = solve_all(partition_by_landmark(problem, 1))
            w1r = solve_all(partition_by_landmark(relabelled(problem), 1))
        finally:
            dist.destroy_process_group()
    w2 = spawn.run(solve_all, 2, partition_by_landmark(problem, 2), backend="gloo")[0]
    for (lm, cg), a, r, b in zip(BUDGETS, w1, w1r, w2):
        def gap(x, y):
            return float((x[1] - y[1]).abs().max())

        print(f"[gap] {lm} LM x {cg} CG: final cost world 1 {float(a[0][-1]):.9g}, "
              f"relabelled {float(r[0][-1]):.9g}, world 2 {float(b[0][-1]):.9g}; poses: "
              f"world 2 {gap(b, a):.3e} and relabelled {gap(r, a):.3e} from world 1; "
              f"from the truth {float((a[1] - truth).abs().max()):.4f} / "
              f"{float((r[1] - truth).abs().max()):.4f} / {float((b[1] - truth).abs().max()):.4f}")


if __name__ == "__main__":
    main()
