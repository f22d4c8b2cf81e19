"""Whether bundle adjustment gives the same bits from run to run on the card,
alone and through the distributed solvers at world 1 (NCCL, this process
alone), on ``chip_smoke.py``'s phase 10b problems: phase 7c's (PCG, 512 x
131,072 x 2,097,152) and phase 7b's 16 x 4,096 window (dense and PCG).

    python3 tools/ba_determinism.py

For each solver prints the largest difference of the cost trace and of
the poses between two single-device runs, between two world-1 runs, and
between the first of each.  A reading on the card only.
"""

from __future__ import annotations

import os
import sys
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import chip_smoke
    import niftymatch_torch as nt
    from niftymatch_torch.parallel import (
        distributed_bundle_adjust,
        distributed_bundle_adjust_cg,
        initialize_distributed,
        make_keyframe_mesh,
    )
    from niftymatch_torch.utils.smoke_parallel import _is_cg, ba_problems

    dev = torch.device("cuda")
    print(f"[det] {chip_smoke.card_line()}")
    problems = ba_problems(worlds=(1,))[0][1]
    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed(f"file://{os.path.join(tmp, 'rendezvous')}", 1, 0, "nccl")
        try:
            mesh = make_keyframe_mesh()
            for name, (sharded, cfg, _) in problems.items():
                single = nt.bundle_adjust_cg if _is_cg(name) else nt.bundle_adjust
                dist_solve = (distributed_bundle_adjust_cg if _is_cg(name)
                              else distributed_bundle_adjust)
                runs = {}
                for tag, fn in (("single", lambda: single(nt.BAProblem(*sharded), cfg,
                                                          device=dev)),
                                ("world1", lambda: dist_solve(sharded, mesh, cfg))):
                    runs[tag] = []
                    for _ in range(2):
                        solved, stats = fn()
                        runs[tag].append((stats.costs.cpu(), solved.poses.cpu()))

                def gap(a, b):
                    return (float((a[0] - b[0]).abs().max()), float((a[1] - b[1]).abs().max()))

                print(f"[det] {name}: costs {runs['single'][0][0].tolist()}")
                for what, a, b in (("single vs single", *runs["single"]),
                                   ("world1 vs world1", *runs["world1"]),
                                   ("single vs world1", runs["single"][0], runs["world1"][0])):
                    c, p = gap(a, b)
                    print(f"[det] {name} {what}: max |cost diff| {c:.6g}, max |pose diff| {p:.3e}, "
                          f"bit for bit {c == 0 and p == 0}")
        finally:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
