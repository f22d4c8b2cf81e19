"""The port's RANSAC (``niftymatch_torch/geometry/ransac.py``), five-point
solver (``geometry/fivepoint.py``), ``align_points`` and mutual matching
(``ops/match.py``) against the JAX package, on the CPU.

RANSAC gets the JAX package's Gumbel draw as ``scores``; then both give
the same inlier mask and transforms within 1e-3 (the 2-D models where
they send the image corners, the epipolar ones entry by entry up to
sign).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import niftymatch_torch as nt
import niftymatch_tpu.geometry.fivepoint  # noqa: F401  (registers the submodule)
from niftymatch_torch.config import RansacConfig as TRansacConfig
from niftymatch_torch.geometry import fivepoint as tf
from niftymatch_torch.geometry import transforms as tt
from niftymatch_torch.ops import match as tm
from niftymatch_tpu.config import RansacConfig as JRansacConfig
from niftymatch_tpu.geometry import transforms as jt
from niftymatch_tpu.ops import match as jm
from torch_parity import (
    PLANAR_TRUTH,
    assert_close_up_to_sign,
    np_,
    planar_correspondences,
    two_view,
)

# ``geometry.ransac`` is also the name of the function the package exports.
jr = sys.modules["niftymatch_tpu.geometry.ransac"]
jf = sys.modules["niftymatch_tpu.geometry.fivepoint"]

CORNERS = np.array([[0, 0], [300, 0], [0, 300], [300, 300]], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


# ---------------------------------------------------------------------------
# RANSAC
# ---------------------------------------------------------------------------


def _ransac_inputs(model, seed, n):
    rng = np.random.default_rng(seed)
    outliers = n // 3
    if model in PLANAR_TRUTH:
        src, dst = planar_correspondences(rng, model, n, outliers)
        tau = 4.0
    else:
        src, dst, _ = two_view(rng, n, outliers=outliers)
        tau = 1e-5
    mask = np.ones(n, bool)
    mask[-8:] = False
    truth = mask.copy()
    truth[:outliers] = False
    return src, dst, mask, truth, tau


@pytest.mark.parametrize("model", ["translation", "similarity", "homography",
                                   "fundamental", "essential", "essential5"])
def test_ransac_matches_jax_with_the_same_draw(model):
    n = 256 if model in PLANAR_TRUTH else 128
    iters = 256
    src, dst, mask, truth, tau = _ransac_inputs(model, seed=3, n=n)
    key = jax.random.key(11)
    scores = np.asarray(jax.random.gumbel(key, (iters, n), jnp.float32))
    rj = jr.ransac(_j(src), _j(dst), _j(mask),
                   JRansacConfig(iterations=iters, inlier_threshold=tau),
                   model=model, key=key)
    rt = nt.ransac(src, dst, mask, TRansacConfig(iterations=iters, inlier_threshold=tau),
                   model=model, scores=scores, device="cpu")
    assert bool(rj.success) and bool(rt.success)
    np.testing.assert_array_equal(np_(rt.inliers), np.asarray(rj.inliers))
    assert int(rt.num_inliers) == int(rj.num_inliers) >= 0.95 * truth.sum()
    if model in PLANAR_TRUTH:
        cj = np.asarray(jt.apply_homography(rj.transform, _j(CORNERS)))
        ct = np_(tt.apply_homography(rt.transform, _t(CORNERS)))
        np.testing.assert_allclose(ct, cj, atol=1e-3)
        np.testing.assert_allclose(ct, np.asarray(jt.apply_homography(
            _j(PLANAR_TRUTH[model]), _j(CORNERS))), atol=0.05)
    else:
        assert_close_up_to_sign(rt.transform, rj.transform, 1e-3)


def test_ransac_default_draw_is_seeded():
    """Without ``scores`` the draw comes from ``config.seed``: the same seed
    gives the same result, and the model is found."""
    src, dst, mask, truth, tau = _ransac_inputs("homography", seed=5, n=200)
    cfg = TRansacConfig(iterations=128, inlier_threshold=tau, seed=7)
    r1 = nt.ransac(src, dst, mask, cfg, device="cpu")
    r2 = nt.ransac(src, dst, mask, cfg, device="cpu")
    np.testing.assert_array_equal(np_(r1.transform), np_(r2.transform))
    assert (np_(r1.inliers) == truth).all()
    with pytest.raises(ValueError, match="scores"):
        nt.ransac(src, dst, mask, cfg, scores=np.zeros((4, 200), np.float32),
                  device="cpu")


def test_ransac_too_few_points_fails():
    mask = np.zeros(16, bool)
    mask[:3] = True
    res = nt.ransac(np.zeros((16, 2), np.float32), np.zeros((16, 2), np.float32),
                    mask, TRansacConfig(iterations=32), device="cpu")
    assert not bool(res.success)


def _distinct_solutions(e, valid, constraint_tol):
    """Valid candidates that satisfy the essential constraints within
    ``constraint_tol`` (the others are complex roots' projections)."""
    out = []
    for m in np_(e)[np_(valid)]:
        c = 2 * m @ m.T @ m - np.trace(m @ m.T) * m
        if max(np.abs(c).max(), abs(np.linalg.det(m))) < constraint_tol:
            out.append(m)
    return out


def test_essential_from_five_matches_jax_as_sets():
    """Each clear solution (cubic constraints within 1e-3) of one side is
    among the other side's valid candidates, up to sign, within 5e-2; and
    over the seeds the true essential matrix is found within 2e-2.  Close
    pairs of real roots come out of the fp32 root finder a few 1e-2 apart
    in either package (the JAX test holds its candidates to the truth at
    2e-2, ``tests/test_fivepoint.py``)."""
    found = 0
    for seed in range(8):
        x1, x2, e_true = two_view(np.random.default_rng(seed), 5)
        ej, vj = jf.essential_from_five(_j(x1), _j(x2))
        et, vt = tf.essential_from_five(_t(x1), _t(x2))
        for mine, mv, other, ov in ((et, vt, ej, vj), (ej, vj, et, vt)):
            pool = np_(other)[np_(ov)]
            for m in _distinct_solutions(mine, mv, 1e-3):
                d = min(min(np.abs(m - p).max(), np.abs(m + p).max()) for p in pool)
                assert d < 5e-2, (seed, d)
        found += any(min(np.abs(m - e_true).max(), np.abs(m + e_true).max()) < 2e-2
                     for m in np_(et)[np_(vt)])
    assert found >= 7


def test_fit_essential5_batched_matches_single():
    x1, x2, _ = two_view(np.random.default_rng(3), 20)
    w = np.zeros((3, 20), np.float32)
    for i in range(3):
        w[i, 3 * i:3 * i + 5] = 1.0
    eb, vb = tf.fit_essential5(_t(x1), _t(x2), _t(w))
    for i in range(3):
        e1, v1 = tf.essential_from_five(_t(x1[3 * i:3 * i + 5]), _t(x2[3 * i:3 * i + 5]))
        np.testing.assert_array_equal(np_(vb[i]), np_(v1))
        np.testing.assert_allclose(np_(eb[i]), np_(e1), atol=1e-5)


# ---------------------------------------------------------------------------
# align_points and mutual matching
# ---------------------------------------------------------------------------


def test_align_points_matches_jax(rng):
    xa, ya = rng.uniform(0, 100, (2, 12)).astype(np.float32)
    xb, yb = rng.uniform(0, 100, (2, 9)).astype(np.float32)
    idx = rng.integers(-1, 9, 12).astype(np.int32)
    valid = rng.uniform(size=12) > 0.2
    for a_valid in (None, valid):
        want = jr.align_points(*map(_j, (xa, ya, xb, yb, idx)),
                               None if a_valid is None else _j(a_valid))
        got = nt.align_points(xa, ya, xb, yb, idx, a_valid, device="cpu")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np_(g), np.asarray(w))


def _descs(rng, m, n):
    a = rng.normal(size=(m, 128)).astype(np.float32)
    b = rng.normal(size=(n, 128)).astype(np.float32)
    b[: m // 2] = a[: m // 2] + 0.05 * rng.normal(size=(m // 2, 128)).astype(np.float32)
    return a, b


def test_mutual_matches_match_jax(rng):
    a, b = _descs(rng, 60, 50)
    fj = jm.match_descriptors(_j(a), _j(b))
    bj = jm.match_descriptors(_j(b), _j(a))
    want = np.asarray(jm.mutual_matches(fj, bj))
    ft, bt = tm.match_descriptors(_t(a), _t(b)), tm.match_descriptors(_t(b), _t(a))
    got = np_(tm.mutual_matches(ft, bt))
    np.testing.assert_array_equal(got, want)
    assert (want >= 0).sum() > 20
    # A leading batch axis: two pairs at once.
    batch = tm.mutual_matches(*[tm.MatchResult(*[torch.stack([u, u]) for u in r])
                                for r in (ft, bt)])
    np.testing.assert_array_equal(np_(batch), np.stack([want, want]))


def test_mutual_ratio_match_matches_jax(rng):
    pairs = [_descs(rng, 40, 40) for _ in range(2)]
    va = rng.uniform(size=(2, 40)) > 0.1
    vb = rng.uniform(size=(2, 40)) > 0.1
    got = np_(tm.mutual_ratio_match(_t(np.stack([p[0] for p in pairs])), _t(va),
                                    _t(np.stack([p[1] for p in pairs])), _t(vb)))
    for i, (a, b) in enumerate(pairs):
        want = np.asarray(jm.mutual_ratio_match(_j(a), _j(va[i]), _j(b), _j(vb[i])))
        np.testing.assert_array_equal(got[i], want)
        assert (want >= 0).sum() > 10


def test_geometry_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    z = np.zeros((8, 2), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        nt.ransac(z, z, np.ones(8, bool), TRansacConfig(iterations=4))
    with pytest.raises(RuntimeError, match="CUDA"):
        nt.align_points(z[:, 0], z[:, 1], z[:, 0], z[:, 1], np.zeros(8, np.int32))
