"""Kernel K1 of the port (``niftymatch_torch/kernels/match.py``) and the
port's ``ops/match.py`` against the JAX package.

The plain K1 is held against the Pallas kernel in interpret mode
(``fused_match_topk(tm=64, tn=64, interpret=True)``) and against the jnp
``top2_min`` oracle: min1/min2 within 1e-3, indices exact wherever the
top-2 gap exceeds 1e-3 (an exact-duplicate descriptor leaves min2 at
rounding noise, ``pallas/match.py:27-35``).  The kernel itself is held
against the plain version on a card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niftymatch_torch.kernels import match as tk
from niftymatch_torch.ops import match as tm
from niftymatch_tpu.ops import match as jm
from niftymatch_tpu.pallas.match import fused_match_topk, match_descriptors_pallas
from torch_parity import np_


def _descs(rng, m, n, d=128):
    a = rng.normal(size=(m, d)).astype(np.float32)
    b = rng.normal(size=(n, d)).astype(np.float32)
    k = min(m, n) // 2
    b[:k] = a[:k] + 0.01 * rng.normal(size=(k, d)).astype(np.float32)
    return a, b


def _assert_top2_close(got, want, atol, gap=1e-3):
    g1, gi, g2 = (np_(t) for t in got)
    w1, wi, w2 = (np.asarray(t) for t in want)
    np.testing.assert_allclose(g1, w1, atol=atol, rtol=1e-5)
    np.testing.assert_allclose(g2, w2, atol=atol, rtol=1e-5)
    unique = (w2 - w1) > gap
    assert unique.mean() > 0.9
    np.testing.assert_array_equal(gi[unique], wi[unique])


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("m,n", [(64, 64), (100, 200), (300, 77), (33, 500)])
def test_plain_k1_matches_pallas_interpret_and_oracle(rng, m, n, with_valid):
    a, b = _descs(rng, m, n)
    bv = np.ones(n, bool)
    if with_valid:
        bv[n // 3 :: 4] = False
    jb_valid = jnp.asarray(bv) if with_valid else None
    tb_valid = torch.from_numpy(bv) if with_valid else None
    got = tk.fused_match_topk(torch.from_numpy(a), torch.from_numpy(b), tb_valid)
    want = fused_match_topk(jnp.asarray(a), jnp.asarray(b), jb_valid,
                            tm=64, tn=64, interpret=True)
    _assert_top2_close(got, want, atol=1e-3)
    d = jm.pairwise_sq_distances(jnp.asarray(a), jnp.asarray(b[bv]))
    o1, oi, o2 = jm.top2_min(d)
    oi = np.flatnonzero(bv)[np.asarray(oi)]
    _assert_top2_close(got, (o1, oi, o2), atol=1e-3)


def test_plain_k1_no_valid_and_single_column(rng):
    a, b = _descs(rng, 5, 3)
    min1, _, _ = tk.fused_match_topk(torch.from_numpy(a), torch.from_numpy(b),
                                     torch.zeros(3, dtype=torch.bool))
    assert (np_(min1) >= tk.NOVALID).all()
    res = tk.match_descriptors_fused(torch.from_numpy(a), torch.from_numpy(b[:1]))
    ref = jm.match_descriptors(jnp.asarray(a), jnp.asarray(b[:1]))
    np.testing.assert_array_equal(np_(res.indices), np.asarray(ref.indices))


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_match_descriptors_fused_matches_jax(rng, precision):
    a, b = _descs(rng, 128, 128)
    av = np.ones(128, bool)
    av[-10:] = False
    bv = np.ones(128, bool)
    bv[-7:] = False
    ja, jb, jav, jbv = map(jnp.asarray, (a, b, av, bv))
    ta, tb, tav, tbv = map(torch.from_numpy, (a, b, av, bv))
    ref = jm.match_descriptors(ja, jb, a_valid=jav, b_valid=jbv, precision=precision)
    fused = tk.match_descriptors_fused(ta, tb, a_valid=tav, b_valid=tbv,
                                       precision=precision)
    plain = tm.match_descriptors(ta, tb, a_valid=tav, b_valid=tbv,
                                 precision=precision)
    matched = np.asarray(ref.indices) >= 0
    assert matched.sum() > 40
    for res in (fused, plain):
        np.testing.assert_array_equal(np_(res.indices), np.asarray(ref.indices))
        np.testing.assert_allclose(np_(res.distances)[matched],
                                   np.asarray(ref.distances)[matched],
                                   atol=1e-3, rtol=1e-5)
        np.testing.assert_allclose(np_(res.ratios)[matched],
                                   np.asarray(ref.ratios)[matched], atol=1e-5)
    if precision == "fp32":
        pal = match_descriptors_pallas(ja, jb, a_valid=jav, b_valid=jbv,
                                       interpret=True)
        np.testing.assert_array_equal(np_(fused.indices), np.asarray(pal.indices))


def test_batched_pairs_equal_single(rng):
    pairs = [_descs(rng, 96, 80) for _ in range(3)]
    a = torch.from_numpy(np.stack([p[0] for p in pairs]))
    b = torch.from_numpy(np.stack([p[1] for p in pairs]))
    bv = torch.from_numpy(rng.uniform(size=(3, 80)) > 0.2)
    batch = tk.fused_match_topk(a, b, bv)
    for i in range(3):
        single = tk.fused_match_topk(a[i], b[i], bv[i])
        for x, y in zip(batch, single):
            np.testing.assert_array_equal(np_(x[i]), np_(y))
