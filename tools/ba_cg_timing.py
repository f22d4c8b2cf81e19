"""Phase 7c's PCG bundle adjustment timed on the card: ``bundle_adjust_cg``
on the 512 x 131,072 x 2,097,152 problem at 6 LM x 24 CG iterations, from
the package of this checkout or of another one:

    python3 tools/ba_cg_timing.py [--root DIR] [--reps 4]

One warm-up solve, then ``--reps`` timed solves of the same problem.
Prints each one's host wall s and CUDA-event ms, and whether every solve
gave the first one's bits (cost trace and poses).  To compare two
checkouts, run the script with each ``--root`` in turns (parent, change,
change, parent) on the same card.  A reading on the card only.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                        help="the checkout whose niftymatch_torch is timed")
    parser.add_argument("--reps", type=int, default=4)
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import niftymatch_torch as nt
    from niftymatch_torch.utils.precision import state_to
    from niftymatch_torch.utils.smoke_sfm import global_problem

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[7c] {card.strip()}; package {Path(nt.__file__).parent}")
    dev = torch.device("cuda")
    _, problem = global_problem()
    problem = state_to(problem, dev)
    cfg = nt.BAConfig(max_iterations=6, damping=1e-3, cg_iterations=24)
    nt.bundle_adjust_cg(problem, cfg, device=dev)
    torch.cuda.synchronize()
    first, same = None, True
    for rep in range(args.reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        solved, stats = nt.bundle_adjust_cg(problem, cfg, device=dev)
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = (stats.costs.cpu(), solved.poses.cpu())
        first = first or got
        same = same and all(torch.equal(a, b) for a, b in zip(got, first))
        print(f"[7c] solve {rep}: {wall:.4f} s wall, {start.elapsed_time(end):.2f} ms between "
              f"events, final cost {float(stats.final_cost):.9g}")
    print(f"[7c] every solve the first one's bits: {same}")


if __name__ == "__main__":
    main()
