"""K4's path, the fold microbenchmark, on the card: the operands, one call of
a variant, the work a launch must do, and the timed rows.  ``chip_smoke.py``
phases 2 and 5, ``tools/fold_micro.py`` and the card tests use it.

The operands are ``nb`` pairs of k x 128 uniform [0, 1) descriptors from
``np.random.default_rng(0)`` (B first, then A, as
``benchmarks/fold_micro.py:314`` draws them), rounded to bf16 with fp32
norms.  ``full`` is K1 in bf16 on the same operands.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import _build

VARIANTS = _build.K4_FOLDS + ("full",)
D = 128
REPS = 50   # graph replays a timing


def operands(k: int, nb: int, device, seed: int = 0):
    """(a_mat, a_norm, b_mat, b_norm): bf16 operands and fp32 norms."""
    from ..kernels.match import prepare_descriptors

    rng = np.random.default_rng(seed)
    b = torch.from_numpy(rng.random((nb, k, D), np.float32)).to(device)
    a = torch.from_numpy(rng.random((nb, k, D), np.float32)).to(device)
    a_mat, a_norm = prepare_descriptors(a, bf16=True)
    b_mat, b_norm = prepare_descriptors(b, bf16=True)
    return a_mat, a_norm, b_mat, b_norm


def call(variant: str, ops):
    """One launch of ``variant`` on ``operands``' tensors."""
    from ..kernels import fold
    from ..kernels.match import fused_match_topk_prepared

    a_mat, a_norm, b_mat, b_norm = ops
    if variant == "full":
        return fused_match_topk_prepared(a_mat, b_mat, a_norm, b_norm)
    return fold.fold_variant(a_mat, b_mat, b_norm, variant)


def work(k: int, nb: int, variant: str):
    """(bytes, bf16 operations) of one launch over nb pairs of k: each input
    read once (a, b, b's norms and, for ``full``, a's), each of the three
    outputs written once, and the products 2 nb k^2 128."""
    ops = 2 * nb * k * k * D
    nbytes = nb * k * (2 * D * 2 + 4 * (1 + (variant == "full")) + 3 * 4)
    return nbytes, ops


def run(k: int, nb: int, timer, bound, variants=VARIANTS, reps: int = REPS,
        device="cuda"):
    """One row per variant: ms (``timer(fn, reps)``), the bound
    (``bound(nbytes, ops)`` gives (ms, "bytes" or "operations")), the
    percent of the bound reached, and the µs above the ``rowsum`` floor (a
    full-row sum: every product consumed, one add each)."""
    ops = operands(k, nb, device)
    rows = []
    for v in variants:
        bound_ms, bound_by = bound(*work(k, nb, v))
        ms = timer(lambda: call(v, ops), reps)
        rows.append({"fold": v, "k": k, "nb": nb, "ms": ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "pct_of_bound": 100.0 * bound_ms / ms})
    floor = next((r["ms"] for r in rows if r["fold"] == "rowsum"), None)
    for r in rows:
        r["us_over_rowsum"] = None if floor is None else 1e3 * (r["ms"] - floor)
    return rows
