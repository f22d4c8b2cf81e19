"""Times K4, the fold microbenchmark (``niftymatch_torch/kernels/fold.py``),
on a GPU: the counterpart of ``benchmarks/fold_micro.py``'s command line.

    python3 tools/fold_micro.py [--k 1024] [--nb 16] [--variants gemm rowsum ...]
                                [--turns 2] [--reps 50]

Builds K1 and K4 (``csrc/match.cu``, ``csrc/fold_micro.cu``) and times each
variant on ``niftymatch_torch.utils.smoke_fold.operands`` with
``smoke_fold.run``: ``ms``, the mean replay of a CUDA graph of one launch
over all pairs (``chip_smoke.graph_ms``, the meaning K4's earlier rows
have), and ``ms_in_run``, a launch's share of a graph of 20; ``full`` is K1
in bf16 on the same operands.  The whole sweep runs ``--turns`` times.  Prints one JSON row per variant and turn: the times,
the bound (2 nb k^2 128 operations at the tensor cores' bf16 rate, or the
operands' bytes at the memory rate, whichever is larger), the percent of
the bound reached, the µs above the ``rowsum`` floor, and the replay of a
graph of one 1-element ``zero_()`` (the timer's floor); then the card's
name and power limit.  Writes no file.  Needs one CUDA card; imports
nothing of JAX.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from niftymatch_torch.kernels import _build  # noqa: E402
from niftymatch_torch.utils import smoke_fold  # noqa: E402


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--k", type=int, default=1024)
    parser.add_argument("--nb", type=int, default=16)
    parser.add_argument("--variants", nargs="+", default=list(smoke_fold.VARIANTS),
                        choices=smoke_fold.VARIANTS)
    parser.add_argument("--turns", type=int, default=2)
    parser.add_argument("--reps", type=int, default=smoke_fold.REPS)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    _build.build_all(("match", "fold_micro"))
    for turn in range(args.turns):
        rows = smoke_fold.run(args.k, args.nb, chip_smoke.graph_ms, chip_smoke.bf16_bound,
                              args.variants, args.reps)
        for row in rows:
            print(json.dumps({"turn": turn, **row}))
    print(chip_smoke.card_line())


if __name__ == "__main__":
    main()
