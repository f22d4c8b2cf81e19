"""Readings that set the limits of a cell's comparison.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--seconds S]
        [--control-seeds 1,2,3]

For each seed, one process runs what a run of the cell runs (set-up,
warm-up, ``--seconds`` of steps, release) and prints the program's numbers
against the plain reference (the lower readings); for each control seed it
also prints the control's numbers: the reference in the precision below the
configuration's, put in the program's place (the upper readings).  Then a
summary: per number, the largest program reading and the smallest control
reading.  The benchmark's own runs never run the control.  Needs a CUDA card
unless ``--device cpu`` (the program's plain path, for tests).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seed, seconds, device, with_control):
    from portbench import harness
    from portbench.trace import Spans

    gen = cell.gen
    st = gen.setup(cell.config, cell.mix, seed, device, Spans())
    gen.warmup(st)
    t0 = time.perf_counter()
    while True:
        gen.step(st)
        if time.perf_counter() - t0 >= seconds:
            break
    harness.sync(device)
    gen.release(st)
    out = {"seed": seed, "steps": gen.attempted(st), "program": gen.program_numbers(st)}
    if with_control:
        out["control"] = gen.control(st)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    harness.exact_fp32()
    harness.build_kernels(device)
    cell = harness.Cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in seeds:
        row = readings(cell, seed, args.seconds, device, seed in ctrl)
        rows.append(row)
        print(json.dumps(row), flush=True)
    names = rows[0]["program"].keys()
    summary = {"lower": {n: max(r["program"][n] for r in rows) for n in names}}
    with_ctrl = [r for r in rows if "control" in r]
    if with_ctrl:
        summary["upper"] = {n: min(r["control"][n] for r in with_ctrl)
                            for n in with_ctrl[0]["control"]}
    print(json.dumps({"summary": summary, "workload": args.workload}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
