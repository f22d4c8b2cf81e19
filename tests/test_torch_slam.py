"""The port's SLAM tracking (``niftymatch_torch/slam/frontend.py``'s
``masked_median``, ``slam_step``, ``slam_chunk`` and ``slam/system.py``'s
``SlamSystem``) against the JAX package, on the CPU.

Inputs: ``make_feature_sequence`` of 8 cameras, 400 landmarks and 384
slots (the JAX tests' size, ``tests/test_slam_e2e.py:23-43``), built bit
for bit alike by both packages.  The JAX package's SLAM step draws its
RANSAC samples from ``jax.random.key(seed)`` on every frame for both
models; the port gets that draw, ``gumbel(key(0), (512, 384))``, as its
``(scores_e, scores_h)`` pair.

Tolerances: match indices, inlier masks, success, keyframe flags, inlier
counts and track ids exact; poses, world points and trajectories within
1e-3.  The two packages' fp32 8-point refits each lie ~9e-4 from the
float64 fit, so a correspondence within a few per cent of the inlier
threshold can fall on either side: on this sequence one does so at
frame 3, and with no BA between frames the scale chain then carries the
two-view difference (R, t within 1e-3, ``test_torch_twoview.py``) into
the trajectory (~5e-3 by frame 7).  So the step and chunk tests run the
frames before it, and the systems run with window BA at the end of every
chunk (``ba_every=3``), where both packages converge to the same window
optimum.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import niftymatch_torch.data.synthetic as tsyn
import niftymatch_tpu.data.synthetic as jsyn
from niftymatch_torch.config import RansacConfig as TRansacConfig
from niftymatch_torch.features import Features as TFeatures
from niftymatch_torch.slam import SlamConfig as TSlamConfig
from niftymatch_torch.slam import SlamSystem as TSlamSystem
from niftymatch_torch.slam import frontend as tfront
from niftymatch_tpu.config import RansacConfig as JRansacConfig
from niftymatch_tpu.slam import SlamConfig as JSlamConfig
from niftymatch_tpu.slam import SlamSystem as JSlamSystem
from niftymatch_tpu.slam import frontend as jfront
from torch_parity import np_

ITERS, CAP = 512, 384
TOL = 1e-3


@pytest.fixture(scope="module")
def seq():
    """(scene, JAX features, port features, intrinsics, the JAX draw)."""
    scene = jsyn.make_scene(num_cams=8, num_landmarks=400, seed=0, radius=6.0,
                            width=640, height=480)
    jf = jsyn.make_feature_sequence(scene, capacity=CAP, noise_px=0.5, seed=0)
    tf = tsyn.make_feature_sequence(scene, capacity=CAP, noise_px=0.5, seed=0)
    draw = np.array(jax.random.gumbel(jax.random.key(0), (ITERS, CAP), jnp.float32))
    return scene, jf, tf, tuple(float(v) for v in scene.intrinsics), draw


def _configs(intr, **kw):
    common = dict(width=640, height=480, intrinsics=intr, detector_features=CAP, **kw)
    return (JSlamConfig(ransac=JRansacConfig(ITERS, 4.0), **common),
            TSlamConfig(ransac=TRansacConfig(ITERS, 4.0), **common))


# ---------------------------------------------------------------------------
# masked_median
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_true", [7, 8, 1], ids=["odd", "even", "one"])
def test_masked_median_matches_jax(rng, n_true):
    values = rng.normal(size=40).astype(np.float32)
    mask = np.zeros(40, bool)
    mask[rng.choice(40, n_true, replace=False)] = True
    got = float(tfront.masked_median(torch.from_numpy(values), torch.from_numpy(mask)))
    want = float(jfront.masked_median(jnp.asarray(values), jnp.asarray(mask)))
    assert got == want == float(np.median(values[mask]))


# ---------------------------------------------------------------------------
# slam_step and slam_chunk
# ---------------------------------------------------------------------------


def _step_inputs(jsys, jf, k):
    """The JAX system's slam_step inputs for frame k after frames < k."""
    last = jsys.keyframes[-1]
    ids = last.track_ids
    has = (ids >= 0) & jsys.track_alive[np.maximum(ids, 0)]
    return last.feats, jf[k], np.asarray(last.pose), jsys.track_positions[np.maximum(ids, 0)], has


def _check_step(got, want):
    for name in ("indices", "inliers", "success", "points_valid"):
        np.testing.assert_array_equal(np_(getattr(got, name)),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_array_equal(np_(got.num_inliers), np.asarray(want.num_inliers))
    np.testing.assert_allclose(np_(got.pose), np.asarray(want.pose), atol=TOL)
    np.testing.assert_allclose(np_(got.scale), np.asarray(want.scale), atol=TOL)
    valid = np.asarray(want.points_valid)
    np.testing.assert_allclose(np_(got.points_w)[valid], np.asarray(want.points_w)[valid],
                               atol=TOL)


def test_slam_step_matches_jax(seq):
    """Frames 1 and 2 from the JAX system's own state (frame 2 resolves
    its scale from frame 1's landmarks)."""
    scene, jf, tf, intr, draw = seq
    jcfg, _ = _configs(intr, ba_every=10_000)
    jsys = JSlamSystem(jcfg)
    jsys.process_features(jf[0])
    jstep = jax.jit(functools.partial(jfront.slam_step, intrinsics=intr,
                                      ransac_config=jcfg.ransac))
    for k in (1, 2):
        last_feats, feats, pose, world, has = _step_inputs(jsys, jf, k)
        want = jstep(last_feats, feats, pose, world, has)
        tlast = TFeatures(*[torch.from_numpy(np.array(a)) for a in last_feats])
        got = tfront.slam_step(tlast, tf[k], pose, world, has, intr,
                               TRansacConfig(ITERS, 4.0), scores=(draw, draw), device="cpu")
        assert int(want.num_inliers) > 300
        _check_step(got, want)
        jsys.process_features(jf[k])


def test_slam_chunk_matches_jax(seq):
    """Frames 1-2 as one chunk against keyframe 0, and the draw made by
    ``slam_chunk`` itself equal to passing ``_gumbel_scores`` twice."""
    scene, jf, tf, intr, draw = seq
    cap = CAP
    world, has = np.zeros((cap, 3), np.float32), np.zeros(cap, bool)
    pose = np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32)
    jbatch = jax.tree.map(lambda *a: jnp.stack(a), *jf[1:3])
    want, want_acc = jax.jit(functools.partial(
        jfront.slam_chunk, intrinsics=intr, ransac_config=JRansacConfig(ITERS, 4.0),
        min_inliers=15))(jf[0], jbatch, pose, world, has)
    tbatch = TFeatures(*[torch.stack(a) for a in zip(*tf[1:3])])
    tcfg = TRansacConfig(ITERS, 4.0)
    got, got_acc = tfront.slam_chunk(tf[0], tbatch, pose, world, has, intr, tcfg, 15,
                                     scores=(draw, draw), device="cpu")
    np.testing.assert_array_equal(np_(got_acc), np.asarray(want_acc))
    assert np_(got_acc).all()
    for i in range(2):
        _check_step(tfront.SlamStepResult(*[f[i] for f in got]),
                    jfront.SlamStepResult(*[f[i] for f in want]))
    own, _ = tfront.slam_chunk(tf[0], tbatch, pose, world, has, intr, tcfg, 15,
                               device="cpu")
    drawn = tfront._gumbel_scores(ITERS, cap, tcfg.seed, torch.device("cpu"))
    twice, _ = tfront.slam_chunk(tf[0], tbatch, pose, world, has, intr, tcfg, 15,
                                 scores=(drawn, drawn), device="cpu")
    np.testing.assert_array_equal(np_(own.pose), np_(twice.pose))


# ---------------------------------------------------------------------------
# SlamSystem
# ---------------------------------------------------------------------------


def _check_systems(tsys, tinfo, jsys, jinfo):
    assert [i["keyframe"] for i in tinfo] == [i["keyframe"] for i in jinfo]
    assert all(i["keyframe"] for i in tinfo)
    assert [i["num_inliers"] for i in tinfo] == [i["num_inliers"] for i in jinfo]
    assert [i["tracked"] for i in tinfo] == [i["tracked"] for i in jinfo]
    assert len(tsys.keyframes) == len(jsys.keyframes) == 8
    for a, b in zip(tsys.keyframes, jsys.keyframes):
        np.testing.assert_array_equal(a.track_ids, b.track_ids)
    np.testing.assert_allclose(tsys.trajectory(), jsys.trajectory(), atol=TOL)
    np.testing.assert_allclose(tsys.track_positions[: tsys._next_track],
                               jsys.track_positions[: jsys._next_track], atol=1e-2)


def test_process_features_matches_jax(seq):
    """The per-frame path with window BA every 3 keyframes over 4."""
    scene, jf, tf, intr, draw = seq
    jcfg, tcfg = _configs(intr, ba_every=3, ba_window=4)
    jsys, tsys = JSlamSystem(jcfg), TSlamSystem(tcfg, device="cpu", scores=(draw, draw))
    jinfo = [jsys.process_features(f) for f in jf]
    tinfo = [tsys.process_features(f) for f in tf]
    _check_systems(tsys, tinfo, jsys, jinfo)


def test_process_features_batch_matches_jax(seq):
    """The chunked path in chunks of 1 + 3, 3 and 1 frames (window BA at
    each chunk's end, its landmarks harvested by the next chunk's fetch)."""
    scene, jf, tf, intr, draw = seq
    jcfg, tcfg = _configs(intr, ba_every=3, ba_window=4)
    jsys, tsys = JSlamSystem(jcfg), TSlamSystem(tcfg, device="cpu", scores=(draw, draw))
    jinfo, tinfo = [], []
    for a, b in ((0, 4), (4, 7), (7, 8)):
        jinfo += jsys.process_features_batch(jax.tree.map(lambda *x: jnp.stack(x), *jf[a:b]))
        tinfo += tsys.process_features_batch(TFeatures(*[torch.stack(x) for x in zip(*tf[a:b])]))
    _check_systems(tsys, tinfo, jsys, jinfo)


def test_chunked_matches_per_frame(seq):
    """``tests/test_slam_e2e.py:155-189`` on the port: one chunk of all 8
    frames against the per-frame path, without BA."""
    scene, jf, tf, intr, draw = seq
    _, tcfg = _configs(intr, ba_every=10_000)
    per_frame = TSlamSystem(tcfg, device="cpu")
    infos_seq = [per_frame.process_features(f) for f in tf]
    chunked = TSlamSystem(tcfg, device="cpu")
    infos_chk = chunked.process_features_batch(TFeatures(*[torch.stack(x) for x in zip(*tf)]))
    assert [i["keyframe"] for i in infos_chk] == [i["keyframe"] for i in infos_seq]
    assert len(chunked.keyframes) == len(per_frame.keyframes) == 8
    np.testing.assert_allclose(chunked.trajectory(), per_frame.trajectory(), atol=TOL)
    for a, b in zip(chunked.keyframes, per_frame.keyframes):
        np.testing.assert_array_equal(a.track_ids, b.track_ids)
    gt = scene.poses
    centres = -np.einsum("kji,kj->ki", gt[:, :, :3], gt[:, :, 3])
    from niftymatch_torch.utils.metrics import ate_rmse
    extent = np.linalg.norm(centres - centres.mean(0), axis=1).mean()
    assert ate_rmse(chunked.trajectory(), centres) < 0.02 * extent


# ---------------------------------------------------------------------------
# Config and frame preparation
# ---------------------------------------------------------------------------


def test_slam_config_carries_across():
    """``convert.slam_config_from_dict`` of a JAX ``SlamConfig``: every field
    equal, and the two classes' fields and defaults equal."""
    import dataclasses

    from niftymatch_torch.convert import slam_config_from_dict

    assert dataclasses.asdict(TSlamConfig()) == dataclasses.asdict(JSlamConfig())
    j = JSlamConfig(distortion=(-0.1, 0.01, 0.0), ransac=JRansacConfig(512, 4.0, seed=3),
                    chunk_size=16, ba_every=4)
    assert dataclasses.asdict(slam_config_from_dict(dataclasses.asdict(j))) == \
        dataclasses.asdict(j)


def test_frames_undistorted_like_jax(rng):
    """The frames ``process_frames`` detects on: uint8 cast to float32 and
    undistorted as one (H, W, B) remap, against the JAX package's
    ``remap(frame, *undistort_map(...))`` frame by frame, within 1e-3."""
    from niftymatch_tpu.ops.warp import remap, undistort_map

    intr, dist = (300.0, 310.0, 64.0, 48.0), (-0.1, 0.01, 0.002)
    frames = rng.integers(0, 256, size=(3, 96, 128)).astype(np.uint8)
    tsys = TSlamSystem(TSlamConfig(width=128, height=96, intrinsics=intr, distortion=dist),
                       device="cpu")
    got = np_(tsys._images(frames))
    u, v = undistort_map(jnp.asarray(intr, jnp.float32), jnp.asarray(dist, jnp.float32), 96, 128)
    want = np.stack([np.asarray(remap(jnp.asarray(f, jnp.float32), u, v)) for f in frames])
    assert got.dtype == np.float32 and got.shape == (3, 96, 128)
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert np.abs(got - frames).max() > 1.0     # the distortion moved pixels
