"""The plain versions of the port's K4 (``niftymatch_torch/kernels/fold.py``)
against the JAX package's ``_variant_kernel`` (``benchmarks/fold_micro.py``)
in interpret mode, on the CPU.

The ``pallas_call`` is built here with ``_variant_call``'s specs, since that
function takes no ``interpret`` argument.  Operands are uniform [0, 1)
descriptors from a seed through the JAX package's
``prepare_descriptors(bf16=True)`` (``fold_micro.py:314-320``).  k = 512
with tn = 256 gives two B tiles, so the running merge across tiles runs;
tm = 256 with mc = 128 gives two row chunks.  Tolerances are
``kernels.fold.agreement``'s, the ones the card holds the kernel to: values
within 1e-4 of the row's largest |d| (one quantum for ``slotpack`` and
``bf16``), indices equal except where the fp32 top-2 gap is within 1e-5
relative (one quantum); ``gemm``/``rowsum`` give exactly 3.4e38 and
``top2noi`` an index of -1.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from benchmarks.fold_micro import _variant_kernel
from niftymatch_torch.kernels import fold as tf
from niftymatch_torch.kernels import match as tk
from niftymatch_tpu.pallas.match import fused_match_topk_prepared, prepare_descriptors

K, D, NB = 512, 128, 2
TM, TN, MC = 256, 256, 128
VMEM = pltpu.VMEM


def _jax_variant(a_neg2, b, bn, fold):
    """``_variant_call`` with ``interpret=True`` (no padding: k is a
    multiple of the tiles)."""
    nc = TM // MC
    out = pl.pallas_call(
        partial(_variant_kernel, tn=TN, mc=MC, nc=nc, fold=fold),
        grid=(K // TM, K // TN),
        in_specs=[pl.BlockSpec((TM, D), lambda i, j: (i, 0), memory_space=VMEM),
                  pl.BlockSpec((TN, D), lambda i, j: (j, 0), memory_space=VMEM),
                  pl.BlockSpec((1, TN), lambda i, j: (0, j), memory_space=VMEM)],
        out_specs=[pl.BlockSpec((1, 1, TM), lambda i, j: (i, 0, 0),
                                memory_space=VMEM)] * 3,
        out_shape=[jax.ShapeDtypeStruct((K // TM, 1, TM), jnp.float32),
                   jax.ShapeDtypeStruct((K // TM, 1, TM), jnp.int32),
                   jax.ShapeDtypeStruct((K // TM, 1, TM), jnp.float32)],
        scratch_shapes=[pltpu.VMEM((MC, nc), jnp.float32),
                        pltpu.VMEM((MC, nc), jnp.int32),
                        pltpu.VMEM((MC, nc), jnp.float32),
                        pltpu.VMEM((MC, nc * 128), jnp.int32),
                        pltpu.VMEM((MC, nc * 128), jnp.int32)],
        interpret=True,
    )(a_neg2, b, bn)
    return [np.asarray(o).reshape(-1) for o in out]


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(0)
    a = rng.random((NB, K, D), np.float32)
    b = rng.random((NB, K, D), np.float32)
    ja = [prepare_descriptors(jnp.asarray(x), bf16=True) for x in a]
    jb = [prepare_descriptors(jnp.asarray(x), bf16=True) for x in b]
    am, an = tk.prepare_descriptors(torch.from_numpy(a), bf16=True)
    bm, bn = tk.prepare_descriptors(torch.from_numpy(b), bf16=True)
    return ja, jb, (am, an, bm, bn)


@pytest.mark.parametrize("fold", tf.FOLDS)
def test_fold_variant_plain_matches_jax_interpret(operands, fold):
    ja, jb, (am, an, bm, bn) = operands
    want = [np.stack(x) for x in zip(*[
        _jax_variant(pa[0], pb[1], pb[2][None, :], fold) for pa, pb in zip(ja, jb)])]
    got = tf.fold_variant_plain(am, bm, bn, fold, tn=TN)
    d = tf.distances(am, bm, bn)
    res = tf.agreement(fold, got, [torch.from_numpy(w) for w in want], d)
    assert res["ok"], (fold, res)
    # The CPU wrapper is the plain version at the kernel's own tile width.
    again = tf.fold_variant(am, bm, bn, fold)
    assert tf.agreement(fold, again, got, d)["ok"]


def test_full_is_k1_bf16(operands):
    """The TPU benchmark's ``full`` row is K1 in bf16 on the same operands:
    the port's K1 plain version against the JAX package's in interpret
    mode (``||a||^2`` added, clamped at 0)."""
    ja, jb, (am, an, bm, bn) = operands
    for p in range(NB):
        w1, wi, w2 = (np.asarray(x) for x in fused_match_topk_prepared(
            ja[p], jb[p], tm=TM, tn=TN, mc=MC, interpret=True))
        g1, gi, g2 = (x.numpy() for x in tk.fused_match_topk_prepared(am[p], bm[p], an[p],
                                                                      bn[p]))
        scale = np.maximum(np.abs(w1).max(), 1.0)
        assert np.abs(g1 - w1).max() <= 1e-4 * scale
        assert np.abs(g2 - w2).max() <= 1e-4 * scale
        clear = (w2 - w1) > 1e-5 * np.maximum(np.abs(w1), np.abs(w2))
        np.testing.assert_array_equal(gi[clear], wi[clear])


@pytest.mark.parametrize("fold", ["gemm", "rowsum"])
def test_consume_only_sums_at_base_zero(operands, fold):
    """``gemm`` and ``rowsum`` with their sums added to 0 (at 3.4e38 every
    sum reads 3.4e38): -2 a.b summed over column 0 of each tn-wide tile, or
    over every column, against numpy in float64 within 1e-5 relative; the
    CPU wrapper passes ``base`` on."""
    _, _, (am, an, bm, bn) = operands
    ab = np.einsum("pmd,pnd->pmn", am.double().numpy(), bm.double().numpy())
    want = -2.0 * (ab[..., ::TN] if fold == "gemm" else ab).sum(-1)
    g1, gi, g2 = tf.fold_variant_plain(am, bm, bn, fold, tn=TN, base=0.0)
    np.testing.assert_allclose(g1.numpy(), want, rtol=1e-5)
    assert (gi == -1).all() and (g2 == tf.BIG).all()
    c1, _, _ = tf.fold_variant(am, bm, bn, fold, base=0.0)
    assert not torch.equal(c1, torch.full_like(c1, tf.BIG))
    res = tf.agreement(fold, (g1, gi, g2), tf.fold_variant_plain(am, bm, bn, fold, tn=TN),
                       tf.distances(am, bm, bn))
    assert not res["ok"]   # a sum at base 0 is not the benchmark's 3.4e38


def test_unknown_fold_raises(operands):
    _, _, (am, an, bm, bn) = operands
    with pytest.raises(ValueError):
        tf.fold_variant(am, bm, bn, "full")
