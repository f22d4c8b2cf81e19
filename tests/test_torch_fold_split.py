"""K4's column splits on the CPU: the plain version with the CUDA kernel's
decomposition (``fold_variant_plain(..., splits=, split_cols=)``: the
columns cut into parts of whole ``split_cols``-wide units, each part folded
alone, the parts merged in column order with the kernel's rules) against
the unsplit plain result and against the JAX package's ``_variant_kernel``
(``benchmarks/fold_micro.py``) in interpret mode, and the rule that picks
the kernel's split count.

k = 512 with units of 64 columns gives 8 units, so 1, 2, 3 and 7 parts are
all real, most of them uneven.  Tolerances: a merge of parts moves no bit
of the min/top-2 variants, so they equal the unsplit result exactly; against
JAX, ``kernels.fold.agreement``'s (values within 1e-4 of the row's largest
|d|, one quantum for ``slotpack`` and ``bf16``, indices equal outside
rows whose fp32 top-2 gap is within 1e-5 relative); the sums of ``gemm``
and ``rowsum`` against float64 within 1e-5 relative, ``base`` added once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niftymatch_torch.kernels import fold as tf
from niftymatch_torch.kernels import match as tk
from niftymatch_torch.utils import smoke_fold
from test_torch_fold import TN, _jax_variant

K, D, NB = 512, 128, 2
UNIT = 64            # split_cols here: 8 units at k = 512
SPLITS = (1, 2, 3, 7)


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(1)
    a = rng.random((NB, K, D), np.float32)
    b = rng.random((NB, K, D), np.float32)
    am, an = tk.prepare_descriptors(torch.from_numpy(a), bf16=True)
    bm, bn = tk.prepare_descriptors(torch.from_numpy(b), bf16=True)
    return am, an, bm, bn


def _jax(ops, fold):
    """JAX's ``_variant_kernel`` (interpret mode) on the port's operands:
    A as ``-2 a`` in bf16 (exact), B in bf16, B's fp32 norms."""
    am, _, bm, bn = ops
    out = []
    for p in range(am.shape[0]):
        a_neg2 = jnp.asarray((-2.0 * am[p].float()).numpy(), dtype=jnp.bfloat16)
        b = jnp.asarray(bm[p].float().numpy(), dtype=jnp.bfloat16)
        out.append(_jax_variant(a_neg2, b, jnp.asarray(bn[p].numpy())[None, :], fold))
    return [torch.from_numpy(np.stack(x)) for x in zip(*out)]


@pytest.fixture(scope="module")
def jax_results(operands):
    cache = {}

    def get(fold):
        if fold not in cache:
            cache[fold] = _jax(operands, fold)
        return cache[fold]
    return get


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("fold", tf.FOLDS)
def test_split_matches_unsplit_and_jax(operands, jax_results, fold, splits):
    am, _, bm, bn = operands
    assert len(tf.split_bounds(K, splits, UNIT)) == splits
    got = tf.fold_variant_plain(am, bm, bn, fold, tn=TN, splits=splits, split_cols=UNIT)
    whole = tf.fold_variant_plain(am, bm, bn, fold, tn=TN)
    assert all(torch.equal(u, v) for u, v in zip(got, whole)), fold
    res = tf.agreement(fold, got, jax_results(fold), tf.distances(am, bm, bn))
    assert res["ok"], (fold, splits, res)


@pytest.mark.parametrize("base", [0.0, 1000.0])
@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("fold", ["gemm", "rowsum"])
def test_split_sums_add_base_once(operands, fold, splits, base):
    """The parts' sums add up to the whole row's, and ``base`` is added once
    (at 1000, a base added per part would be off by 1000 a part)."""
    am, _, bm, bn = operands
    ab = np.einsum("pmd,pnd->pmn", am.double().numpy(), bm.double().numpy())
    want = base - 2.0 * (ab[..., ::TN] if fold == "gemm" else ab).sum(-1)
    g1, gi, g2 = tf.fold_variant_plain(am, bm, bn, fold, tn=TN, base=base, splits=splits,
                                       split_cols=UNIT)
    np.testing.assert_allclose(g1.numpy(), want, rtol=1e-5)
    assert (gi == -1).all() and (g2 == tf.BIG).all()


@pytest.mark.parametrize("m,n,splits", [(77, 1000, 3), (77, 1000, 7), (130, 1000, 8),
                                        (130, 1, 4)])
@pytest.mark.parametrize("fold", tf.FOLDS)
def test_split_ragged_shapes(fold, m, n, splits):
    """n of no multiple of the kernel's 128-column tile (1000: 8 tiles, the
    last of 104 columns, in uneven parts) or a single column (every split
    count falls to 1; no second value: min2 is 3.4e38) against the unsplit
    result; ``gemm``/``rowsum`` also at ``base`` 0."""
    rng = np.random.default_rng(2)
    am, _ = tk.prepare_descriptors(torch.from_numpy(rng.random((2, m, D), np.float32)), True)
    bm, bn = tk.prepare_descriptors(torch.from_numpy(rng.random((2, n, D), np.float32)), True)
    assert len(tf.split_bounds(n, splits)) == min(splits, -(-n // tf.SPLIT_COLS))
    for base in (tf.BIG, 0.0) if fold in ("gemm", "rowsum") else (tf.BIG,):
        got = tf.fold_variant_plain(am, bm, bn, fold, base=base, splits=splits)
        whole = tf.fold_variant_plain(am, bm, bn, fold, base=base)
        res = tf.agreement(fold, got, whole, tf.distances(am, bm, bn), base=base)
        assert res["ok"], (fold, m, n, splits, base, res)
        if base == tf.BIG:
            assert all(torch.equal(u, v) for u, v in zip(got, whole)), fold
    if n == 1 and fold not in ("gemm", "rowsum", "min1"):
        assert (got[2] == tf.BIG).all()


@pytest.mark.parametrize("fold", tf.FOLDS)
def test_split_cross_tie(operands, fold):
    """Rows whose two minima tie exactly, at a column of the first part and
    one of the last (``smoke_fold.plant_ties``): split 7 ways, the lower
    column keeps idx1 and min2 equals min1, as in the unsplit result and in
    JAX's."""
    splits = 7
    bounds = tf.split_bounds(K, splits, UNIT)
    rows = list(range(0, K, 97))
    ties = [(p, i, bounds[0][0] + j, bounds[-1][0] + j)
            for j, i in enumerate(rows) for p in range(NB)]
    tied = smoke_fold.plant_ties(operands, ties)
    am, _, bm, bn = tied
    got = tf.fold_variant_plain(am, bm, bn, fold, tn=TN, splits=splits, split_cols=UNIT)
    whole = tf.fold_variant_plain(am, bm, bn, fold, tn=TN)
    assert all(torch.equal(u, v) for u, v in zip(got, whole)), fold
    res = tf.agreement(fold, got, _jax(tied, fold), tf.distances(am, bm, bn))
    assert res["ok"], (fold, res)
    g1, gi, g2 = got
    for p, i, c, _ in ties:
        if fold not in ("gemm", "rowsum", "min1"):
            assert g1[p, i] == g2[p, i]
        if fold in ("current", "pipe", "top2idx", "bf16", "slotpack"):
            assert gi[p, i] == c


@pytest.mark.parametrize("pairs,m,n,want", [
    (1, 4096, 4096, 4),      # 32 row blocks x 4: the card filled once
    (16, 1024, 1024, 1),     # 128 CTAs already
    (2, 2048, 2048, 4),
    (3, 1000, 1000, 4),      # 24 row blocks: 5 fit, the power of two 4
    (2, 1000, 1, 1),         # one tile: no split
    (1, 128, 32768, 8),      # at most 8
    (17, 1024, 1024, 1),     # more row blocks than SMs
])
def test_column_splits(pairs, m, n, want):
    got = tf.column_splits(pairs, m, n, 132)
    assert got == want
    assert pairs * -(-m // tf.ROWS) * got <= max(132, pairs * -(-m // tf.ROWS))
