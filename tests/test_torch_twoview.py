"""The port's synthetic scenes and trajectory metrics
(``niftymatch_torch/data/synthetic.py``, ``utils/metrics.py``) and its
two-view front end (``slam/frontend.py``) against the JAX package, on the
CPU.

The generators are numpy copies and must give the JAX package's arrays
bit for bit; the metrics agree within 1e-9.  The two-view estimate gets the
JAX package's two RANSAC draws (``gumbel(key)`` for E, ``gumbel(fold_in(key,
1))`` for H) as ``scores_e`` / ``scores_h``; then it gives the same matches
and inlier mask, and R, t within 1e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import niftymatch_torch as nt
import niftymatch_torch.data.synthetic as tsyn
import niftymatch_torch.utils.metrics as tmet
import niftymatch_tpu.data.synthetic as jsyn
import niftymatch_tpu.utils.metrics as jmet
from niftymatch_torch.config import RansacConfig as TRansacConfig
from niftymatch_torch.ops.match import MatchResult
from niftymatch_torch.slam import frontend as tfront
from niftymatch_tpu.config import RansacConfig as JRansacConfig
from niftymatch_tpu.slam import frontend as jfront
from torch_parity import np_

# ---------------------------------------------------------------------------
# Synthetic data and metrics
# ---------------------------------------------------------------------------


def _assert_same(got, want):
    """Equal arrays of the same dtype, field by field for tuples."""
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
        return
    if isinstance(want, (int, float)):
        assert got == want
        return
    want = np.asarray(want)
    got = np_(got)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(num_cams=5, num_landmarks=100, seed=3, radius=8.0, width=320, height=240),
    dict(num_cams=6, num_landmarks=50, seed=1, arc=(0.0, 2 * np.pi * 5 / 6), helix=0.0),
])
def test_make_scene_bit_identical(kw):
    _assert_same(tsyn.make_scene(**kw), jsyn.make_scene(**kw))


@pytest.mark.parametrize("kw", [
    dict(seed=0, noise_px=0.5),
    dict(seed=2, noise_px=1.0, outlier_frac=0.1, max_obs=4000),
    dict(seed=5, noise_px=0.0, max_obs_per_cam=40),
])
def test_make_observation_table_bit_identical(kw):
    scene = jsyn.make_scene(num_cams=8, num_landmarks=256, seed=kw["seed"])
    _assert_same(tsyn.make_observation_table(scene, **kw),
                 jsyn.make_observation_table(scene, **kw))


@pytest.mark.parametrize("background", ["flat", "sky"])
def test_render_frames_and_photometric_bit_identical(background):
    scene = jsyn.make_scene(num_cams=3, num_landmarks=150, seed=4, width=128, height=96)
    kw = dict(seed=1, background=background)
    if background == "sky":
        kw["distortion"] = (-0.1, 0.01, 0.0)
    frames = tsyn.render_frames(scene, **kw)
    _assert_same(frames, jsyn.render_frames(scene, **kw))
    assert frames.shape == (3, 96, 128) and frames.std() > 1.0
    _assert_same(tsyn.apply_photometric(frames, seed=2),
                 jsyn.apply_photometric(frames, seed=2))


def test_make_feature_sequence_field_by_field():
    scene = jsyn.make_scene(num_cams=3, num_landmarks=200, seed=6)
    got = tsyn.make_feature_sequence(scene, capacity=128, seed=6)
    want = jsyn.make_feature_sequence(scene, capacity=128, seed=6)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert isinstance(g, nt.Features) and g.x.device.type == "cpu"
        for name in nt.Features._fields:
            _assert_same(getattr(g, name), getattr(w, name))


def test_metrics_match_jax(rng):
    src = rng.normal(size=(40, 3))
    theta = 0.7
    R = np.array([[np.cos(theta), -np.sin(theta), 0], [np.sin(theta), np.cos(theta), 0],
                  [0, 0, 1]])
    dst = 1.7 * src @ R.T + np.array([1.0, -2.0, 3.0]) + rng.normal(0, 0.05, src.shape)
    for with_scale in (True, False):
        for g, w in zip(tmet.umeyama_alignment(src, dst, with_scale),
                        jmet.umeyama_alignment(src, dst, with_scale)):
            np.testing.assert_allclose(g, w, atol=1e-9, rtol=0)
        for align in (True, False):
            assert abs(tmet.ate_rmse(src, dst, align, with_scale)
                       - jmet.ate_rmse(src, dst, align, with_scale)) <= 1e-9
    for delta in (1, 3):
        assert abs(tmet.rpe_rmse(src, dst, delta) - jmet.rpe_rmse(src, dst, delta)) <= 1e-9
    a, s = tmet.sim3_align(src, dst)
    b, t = jmet.sim3_align(src, dst)
    np.testing.assert_allclose(a, b, atol=1e-9, rtol=0)
    assert abs(s - t) <= 1e-9


# ---------------------------------------------------------------------------
# Two-view front end
# ---------------------------------------------------------------------------

ITERS = 512


@pytest.fixture(scope="module")
def feature_pair():
    """Two views of a synthetic scene as JAX and port feature sets
    (``make_feature_sequence``: landmark-consistent descriptors, 0.5-px
    keypoint noise)."""
    scene = jsyn.make_scene(num_cams=4, num_landmarks=400, seed=0)
    jf = jsyn.make_feature_sequence(scene, capacity=256, seed=0)
    tf = tsyn.make_feature_sequence(scene, capacity=256, seed=0)
    intr = tuple(float(v) for v in scene.intrinsics)
    return scene, jf, tf, intr


def _draws(seed, n):
    key = jax.random.key(seed)
    return (np.asarray(jax.random.gumbel(key, (ITERS, n), jnp.float32)),
            np.asarray(jax.random.gumbel(jax.random.fold_in(key, 1), (ITERS, n),
                                         jnp.float32)), key)


def _true_rel(scene, a, b):
    Ta, Tb = scene.poses[a].astype(np.float64), scene.poses[b].astype(np.float64)
    R = Tb[:, :3] @ Ta[:, :3].T
    t = Tb[:, 3] - R @ Ta[:, 3]
    return R, t / np.linalg.norm(t)


def _check_two_view(got, want, scene, a, b):
    np.testing.assert_array_equal(np_(got.inliers), np.asarray(want.inliers))
    assert int(got.num_inliers) == int(want.num_inliers) >= 20
    assert bool(got.success) == bool(want.success) is True
    np.testing.assert_allclose(np_(got.R), np.asarray(want.R), atol=1e-3)
    np.testing.assert_allclose(np_(got.t), np.asarray(want.t), atol=1e-3)
    np.testing.assert_array_equal(np_(got.point_valid), np.asarray(want.point_valid))
    R_true, t_true = _true_rel(scene, a, b)
    assert np.abs(np_(got.R) - R_true).max() < 0.02
    assert float(np_(got.t) @ t_true) > 0.99


def test_two_view_from_matches_matches_jax(feature_pair):
    scene, jf, tf, intr = feature_pair
    a, b = 1, 2
    from niftymatch_tpu.ops.match import mutual_matches
    from niftymatch_tpu.sift import match_pair

    m = match_pair(jf[a], jf[b], ambiguity=0.7)
    m = m._replace(indices=mutual_matches(m, match_pair(jf[b], jf[a], ambiguity=0.7)))
    scores_e, scores_h, key = _draws(7, 256)
    jcfg = JRansacConfig(iterations=ITERS, inlier_threshold=4.0)
    tcfg = TRansacConfig(iterations=ITERS, inlier_threshold=4.0)
    want = jax.jit(functools.partial(jfront.two_view_from_matches, intrinsics=intr,
                                     ransac_config=jcfg))(jf[a], jf[b], m, key=key)
    tm = MatchResult(*[torch.from_numpy(np.array(x)) for x in m])
    got = tfront.two_view_from_matches(tf[a], tf[b], tm, intr, tcfg, scores_e=scores_e,
                                       scores_h=scores_h, device="cpu")
    _check_two_view(got, want, scene, a, b)


def test_estimate_two_view_matches_jax(feature_pair):
    scene, jf, tf, intr = feature_pair
    a, b = 0, 1
    scores_e, scores_h, key = _draws(3, 256)
    jcfg = JRansacConfig(iterations=ITERS, inlier_threshold=4.0)
    tcfg = TRansacConfig(iterations=ITERS, inlier_threshold=4.0)
    want = jax.jit(functools.partial(jfront.estimate_two_view, intrinsics=intr,
                                     ransac_config=jcfg))(jf[a], jf[b], key=key)
    got = nt.estimate_two_view(tf[a], tf[b], intr, tcfg, scores_e=scores_e,
                               scores_h=scores_h, device="cpu")
    np.testing.assert_array_equal(np_(got.matches.indices), np.asarray(want.matches.indices))
    assert (np_(got.matches.indices) >= 0).sum() > 50
    _check_two_view(got, want, scene, a, b)
    # Without draws both models take one draw from a generator seeded with
    # ransac_config.seed: the same as passing that draw twice.
    drawn = torch.empty(ITERS, 256).exponential_(
        generator=torch.Generator().manual_seed(tcfg.seed)).log().neg()
    own = nt.estimate_two_view(tf[a], tf[b], intr, tcfg, device="cpu")
    twice = nt.estimate_two_view(tf[a], tf[b], intr, tcfg, scores_e=drawn,
                                 scores_h=drawn, device="cpu")
    np.testing.assert_array_equal(np_(own.inliers), np_(twice.inliers))
    np.testing.assert_array_equal(np_(own.R), np_(twice.R))
