"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the program (``niftymatch_torch``).  Needs the CUDA cards the cell asks
for and fails without them; it never falls back to the CPU.  The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also ``breakdown``,
and last ``checks``: each compared number beside its limit), and the last
lines of standard error repeat the checks.  It exits non-zero, printing no
result, if a module of JAX or of the JAX package is loaded once the run is
over.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()

    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    def log(msg):
        print(f"portbench: {msg}", file=sys.stderr, flush=True)

    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", log=log)
    log(f"card: {card_line()}")
    found = harness.forbidden_modules()
    if found:
        log(f"the run loaded {', '.join(found)}: the port must not import JAX "
            "or the JAX package")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    log(f"correct {result['correct']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    # One process with few threads: the program's host work is small
    # arrays, and a pool of BLAS threads only adds jitter to the window.
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
