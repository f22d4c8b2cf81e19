"""K4's path, the fold microbenchmark, on the card: the operands, one call of
a variant, the work a launch must do, and the timed rows.  ``chip_smoke.py``
phases 2 and 5, ``tools/fold_micro.py`` and the card tests use it.

The operands are ``nb`` pairs of k x 128 uniform [0, 1) descriptors from
``np.random.default_rng(0)`` (B first, then A, as
``benchmarks/fold_micro.py:314`` draws them; B may have another row count
``n``), rounded to bf16 with fp32 norms.  ``full`` is K1 in bf16 on the same
operands.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import _build

VARIANTS = _build.K4_FOLDS + ("full",)
D = 128
REPS = 50       # graph replays a timing
GRAPH_RUN = 20  # launches in the graph whose replay gives the time a launch in a run


def operands(k: int, nb: int, device, seed: int = 0, n: int | None = None):
    """(a_mat, a_norm, b_mat, b_norm): bf16 operands and fp32 norms, A with
    k rows and B with ``n`` (default k)."""
    from ..kernels.match import prepare_descriptors

    rng = np.random.default_rng(seed)
    b = torch.from_numpy(rng.random((nb, k if n is None else n, D), np.float32)).to(device)
    a = torch.from_numpy(rng.random((nb, k, D), np.float32)).to(device)
    a_mat, a_norm = prepare_descriptors(a, bf16=True)
    b_mat, b_norm = prepare_descriptors(b, bf16=True)
    return a_mat, a_norm, b_mat, b_norm


def plant_ties(ops, ties):
    """``operands`` with exact ties planted: for each (pair, row, col, col2)
    in ``ties`` (columns distinct across ties), B's rows ``col`` and ``col2``
    become A's row ``row``, which puts the smallest d there is, -||a||^2,
    at both columns: the row's min1 equals its min2, and its idx1 must be
    the lower column.  Returns new operands; B's norms are recomputed."""
    a_mat, a_norm, b_mat, _ = (t.clone() for t in ops)
    for p, i, c, c2 in ties:
        b_mat[p, c] = a_mat[p, i]
        b_mat[p, c2] = a_mat[p, i]
    b_norm = (b_mat.to(torch.float32) ** 2).sum(-1)
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
    """One row per variant: ``ms``, the mean replay of a CUDA graph of one
    launch (``timer(fn, reps)``), and ``ms_in_run``, a launch's share of a
    graph of ``GRAPH_RUN`` (``timer(fn, reps, GRAPH_RUN)``); the bound
    (``bound(nbytes, ops)`` gives (ms, "bytes" or "operations")), the
    percent of the bound reached, the µs above the ``rowsum`` floor (a
    full-row sum: every product consumed, one add each), and
    ``timer_floor_ms``, the replay of a graph of one 1-element ``zero_()``."""
    ops = operands(k, nb, device)
    zero = torch.zeros(1, device=device)
    timer_floor = timer(zero.zero_, reps)
    rows = []
    for v in variants:
        bound_ms, bound_by = bound(*work(k, nb, v))
        fn = lambda: call(v, ops)  # noqa: E731
        row = {"fold": v, "k": k, "nb": nb, "ms": timer(fn, reps),
               "ms_in_run": timer(fn, reps, GRAPH_RUN), "bound_ms": bound_ms,
               "bound_by": bound_by, "timer_floor_ms": timer_floor}
        row["pct_of_bound"] = 100.0 * bound_ms / row["ms"]
        rows.append(row)
    floor = next((r["ms"] for r in rows if r["fold"] == "rowsum"), None)
    for r in rows:
        r["us_over_rowsum"] = None if floor is None else 1e3 * (r["ms"] - floor)
    return rows
