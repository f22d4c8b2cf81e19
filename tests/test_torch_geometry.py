"""The port's geometry linear algebra, fitters and error functions
(``niftymatch_torch/geometry/{linalg,transforms}.py``) against the JAX
package, on the CPU.

Inputs are made with numpy from a seed and given to both packages.
Tolerances: linear algebra within 1e-4 (eigenvectors and singular vectors
up to sign); fitters and error functions within 1e-4 of each result's
largest entry (fundamental and essential matrices up to sign).  RANSAC
and the five-point solver are in ``tests/test_torch_ransac.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niftymatch_torch.geometry import linalg as tl
from niftymatch_torch.geometry import transforms as tt
from niftymatch_torch.geometry.ransac import MIN_SAMPLES
from niftymatch_tpu.geometry import linalg as jl
from niftymatch_tpu.geometry import transforms as jt
from torch_parity import (
    PLANAR_TRUTH,
    assert_close_up_to_sign,
    np_,
    planar_correspondences,
    two_view,
)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


# ---------------------------------------------------------------------------
# linalg
# ---------------------------------------------------------------------------


def _sym(rng, b, n):
    a = rng.normal(size=(b, n, n)).astype(np.float32)
    return (a + a.transpose(0, 2, 1)) / 2


@pytest.mark.parametrize("n", [3, 9])
def test_jacobi_eigh_matches_jax(rng, n):
    s = _sym(rng, 16, n)
    wj, vj = jl.jacobi_eigh(_j(s))
    wt, vt = tl.jacobi_eigh(_t(s))
    np.testing.assert_allclose(np_(wt), np.asarray(wj), atol=1e-4)
    assert_close_up_to_sign(vt, vj, 1e-4, axis=-2)
    resid = s @ np_(vt) - np_(vt) * np_(wt)[:, None, :]
    assert np.abs(resid).max() < 1e-3


@pytest.mark.parametrize("n", [3, 9])
def test_sorted_eigh_matches_jax(rng, n):
    s = _sym(rng, 16, n)
    wj, vj = jl.sorted_eigh(_j(s))
    wt, vt = tl.sorted_eigh(_t(s))
    np.testing.assert_allclose(np_(wt), np.asarray(wj), atol=1e-4)
    assert (np.diff(np_(wt), axis=-1) >= 0).all()
    assert_close_up_to_sign(vt, vj, 1e-4, axis=-2)


@pytest.mark.parametrize("rank", [8, 9])
def test_smallest_eigvec_matches_jax(rng, rank):
    """A one-dimensional null space (rank 8, the DLT minimal case) and a
    full-rank PSD matrix."""
    b = rng.normal(size=(8, rank, 9)).astype(np.float32)
    m = b.transpose(0, 2, 1) @ b
    vj = jl.smallest_eigvec(_j(m))
    vt = tl.smallest_eigvec(_t(m))
    assert_close_up_to_sign(vt, vj, 1e-4, axis=-1)
    np.testing.assert_allclose(np.linalg.norm(np_(vt), axis=-1), 1.0, atol=1e-5)


def test_svd3x3_matches_jax(rng):
    e = rng.normal(size=(12, 3, 3)).astype(np.float32)
    uj, sj, vtj = jl.svd3x3(_j(e))
    ut, st, vtt = tl.svd3x3(_t(e))
    np.testing.assert_allclose(np_(st), np.asarray(sj), atol=1e-4)
    assert_close_up_to_sign(ut, uj, 1e-4, axis=-2)
    assert_close_up_to_sign(vtt, vtj, 1e-4, axis=-1)
    np.testing.assert_allclose(np_(ut) @ (np_(st)[..., :, None] * np_(vtt)), e, atol=2e-3)


def test_solve_inv_and_cholesky_match_jax(rng):
    a = rng.normal(size=(10, 3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    a[0] = 0.0                                  # singular: zeros on both sides
    b = rng.normal(size=(10, 3)).astype(np.float32)
    np.testing.assert_allclose(np_(tl.solve3x3(_t(a), _t(b))),
                               np.asarray(jl.solve3x3(_j(a), _j(b))), atol=1e-4)
    np.testing.assert_allclose(np_(tl.inv3x3(_t(a))), np.asarray(jl.inv3x3(_j(a))),
                               atol=1e-4)
    for n in (3, 6, 8):
        g = rng.normal(size=(5, n + 2, n)).astype(np.float32)
        spd = g.transpose(0, 2, 1) @ g + 0.1 * np.eye(n, dtype=np.float32)
        rhs = rng.normal(size=(5, n)).astype(np.float32)
        got = np_(tl.cholesky_solve_small(_t(spd), _t(rhs)))
        want = np.asarray(jl.cholesky_solve_small(_j(spd), _j(rhs)))
        np.testing.assert_allclose(got, want, atol=1e-4 * max(1.0, np.abs(want).max()))
    with pytest.raises(ValueError):
        tl.cholesky_solve_small(torch.eye(9), torch.ones(9))


# ---------------------------------------------------------------------------
# fitters and error functions
# ---------------------------------------------------------------------------

def _weights(case, n, k, outliers):
    w = np.zeros(n, np.float32)
    if case == "minimal":
        w[outliers:outliers + k] = 1.0
    elif case == "full":
        w[:] = 1.0
    else:                                        # outliers zeroed
        w[outliers:] = 1.0
    return w


@pytest.mark.parametrize("case", ["minimal", "full", "outliers_zeroed"])
@pytest.mark.parametrize("model", ["translation", "similarity", "homography",
                                   "fundamental", "essential"])
def test_fitters_match_jax(rng, model, case):
    n, outliers = 40, 10
    if model in PLANAR_TRUTH:
        src, dst = planar_correspondences(rng, model, n, outliers)
    else:
        src, dst, e_true = two_view(rng, n, outliers=outliers, spread=True)
    w = _weights(case, n, MIN_SAMPLES[model], outliers)
    want = np.asarray(getattr(jt, f"fit_{model}")(_j(src), _j(dst), _j(w)))
    got = np_(getattr(tt, f"fit_{model}")(_t(src), _t(dst), _t(w)))
    atol = 1e-4 * np.abs(want).max()
    if model in PLANAR_TRUTH:
        np.testing.assert_allclose(got, want, atol=atol)
    else:
        assert_close_up_to_sign(got, want, atol)


def test_batched_fitters_and_errors_match_jax(rng):
    """A batch of weight rows through each fitter, then both error
    functions and the Hartley normalisation, against JAX."""
    src, dst = planar_correspondences(rng, "homography", 64, 16)
    w = (rng.uniform(size=(6, 64)) > 0.5).astype(np.float32)
    sb, db = np.broadcast_to(src, (6, 64, 2)), np.broadcast_to(dst, (6, 64, 2))
    hj = jt.fit_homography(_j(sb), _j(db), _j(w))
    ht = tt.fit_homography(_t(sb), _t(db), _t(w))
    np.testing.assert_allclose(np_(ht), np.asarray(hj), atol=1e-4 * np.abs(hj).max())
    for fn in ("transfer_sq_error",):
        want = np.asarray(getattr(jt, fn)(hj, _j(src)[None], _j(dst)[None]))
        got = np_(getattr(tt, fn)(_t(np.asarray(hj)), _t(src)[None], _t(dst)[None]))
        np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(
        np_(tt.apply_homography(_t(np.asarray(hj)), _t(src)[None])),
        np.asarray(jt.apply_homography(hj, _j(src)[None])), atol=1e-3)
    for got, want in zip(tt.hartley_normalization(_t(sb), _t(w)),
                         jt.hartley_normalization(_j(sb), _j(w))):
        np.testing.assert_allclose(np_(got), np.asarray(want), atol=1e-4 * np.abs(want).max())
    x1, x2, e_true = two_view(rng, 50, outliers=10)
    e = np.stack([e_true, rng.normal(size=(3, 3))]).astype(np.float32)
    want = np.asarray(jt.sampson_sq_error(_j(e), _j(x1)[None], _j(x2)[None]))
    got = np_(tt.sampson_sq_error(_t(e), _t(x1)[None], _t(x2)[None]))
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=1e-4)
