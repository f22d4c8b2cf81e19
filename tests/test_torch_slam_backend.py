"""The port's relocalisation (``niftymatch_torch/slam/reloc.py``), global BA
(``slam/globalba.py``) and SLAM checkpoints (``utils/checkpoint.py``)
against the JAX package, on the CPU.

Inputs are ``make_feature_sequence`` features built bit for bit alike by
both packages, and the port gets the JAX package's SLAM draw,
``gumbel(key(0), (512, 384))``, for both RANSAC models (see
``test_torch_slam.py``).  Tolerances: keyframe flags, relocalisation
flags and anchors, inlier counts and track ids exact; a restored
trajectory within 1e-6 of the saved one (the file holds the same floats);
poses after a resumed frame, a relocalisation or global BA within 1e-3.
"""

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
from niftymatch_torch.utils.checkpoint import load_slam_state, save_slam_state
from niftymatch_tpu.config import RansacConfig as JRansacConfig
from niftymatch_tpu.features import Features as JFeatures
from niftymatch_tpu.slam import SlamConfig as JSlamConfig
from niftymatch_tpu.slam import SlamSystem as JSlamSystem
from niftymatch_tpu.utils import checkpoint as jckpt

ITERS, CAP = 512, 384
DRAW = np.array(jax.random.gumbel(jax.random.key(0), (ITERS, CAP), jnp.float32))


def _systems(scene, **kw):
    common = dict(width=640, height=480, intrinsics=tuple(float(v) for v in scene.intrinsics),
                  detector_features=CAP, **{"ba_every": 10_000, **kw})
    return (JSlamSystem(JSlamConfig(ransac=JRansacConfig(ITERS, 4.0), **common)),
            TSlamSystem(TSlamConfig(ransac=TRansacConfig(ITERS, 4.0), **common),
                        device="cpu", scores=(DRAW, DRAW)))


def _orbit(num_cams):
    scene = jsyn.make_scene(num_cams=num_cams, num_landmarks=400, seed=0, radius=6.0,
                            width=640, height=480)
    return (scene, jsyn.make_feature_sequence(scene, capacity=CAP, noise_px=0.5, seed=0),
            tsyn.make_feature_sequence(scene, capacity=CAP, noise_px=0.5, seed=0))


def _garbage(seed):
    """``tests/test_reloc.py``'s frame of pure noise (random unit
    descriptors and positions): a dropped frame that matches nothing."""
    rng = np.random.default_rng(seed + 91)
    d = rng.normal(size=(CAP, 128)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rows = dict(x=rng.uniform(0, 640, CAP).astype(np.float32),
                y=rng.uniform(0, 480, CAP).astype(np.float32),
                sigma=np.ones(CAP, np.float32), angle=np.zeros(CAP, np.float32),
                response=np.ones(CAP, np.float32), octave=np.zeros(CAP, np.int32),
                level=np.zeros(CAP, np.int32), desc=d, valid=np.ones(CAP, bool))
    return (JFeatures(*[jnp.asarray(rows[k]) for k in JFeatures._fields]),
            TFeatures(*[torch.from_numpy(rows[k]) for k in TFeatures._fields]))


def _outward_ring():
    """``tests/test_reloc.py``'s ring of 48 cameras looking outward at a
    landmark ring: distant frames share no landmarks."""
    rng = np.random.default_rng(1)
    n_lm, n_cam = 1600, 48
    th = rng.uniform(0, 2 * np.pi, n_lm)
    r = rng.uniform(10.0, 14.0, n_lm)
    landmarks = np.stack([r * np.sin(th), rng.uniform(-2.5, 2.5, n_lm), -r * np.cos(th)],
                         axis=1).astype(np.float32)
    poses = []
    for a in np.linspace(0.0, 2 * np.pi * (n_cam - 1) / n_cam, n_cam):
        eye = np.array([6.0 * np.sin(a), 0.05 * np.sin(3 * a), -6.0 * np.cos(a)])
        eye += rng.normal(0, 0.02, 3)
        poses.append(jsyn._look_at(eye, 2.0 * eye))
    scene = jsyn.SyntheticScene(poses=np.stack(poses), landmarks=landmarks,
                                intrinsics=np.array([525.0, 525.0, 320.0, 240.0], np.float32),
                                width=640, height=480)
    return (scene, jsyn.make_feature_sequence(scene, capacity=CAP, noise_px=0.5, seed=1),
            tsyn.make_feature_sequence(scene, capacity=CAP, noise_px=0.5, seed=1))


def _same_state(tsys, jsys, atol=1e-3):
    assert len(tsys.keyframes) == len(jsys.keyframes)
    for a, b in zip(tsys.keyframes, jsys.keyframes):
        np.testing.assert_array_equal(a.track_ids, b.track_ids)
    np.testing.assert_allclose(tsys.trajectory(), jsys.trajectory(), atol=atol)


# ---------------------------------------------------------------------------
# Relocalisation
# ---------------------------------------------------------------------------


def test_garbage_gap_matches_jax():
    """``tests/test_reloc.py:53-80`` at 10 cameras (window BA every 3
    keyframes, see ``test_torch_slam.py``): three garbage frames are
    rejected (their relocalisation attempts stop at the score stage) and
    tracking resumes, per frame and in one chunk."""
    scene, jf, tf = _orbit(10)
    gj, gt = zip(*[_garbage(s) for s in range(3)])
    jsys, tsys = _systems(scene, ba_every=3, ba_window=4)
    jinfo = [jsys.process_features(f) for f in list(jf[:5]) + list(gj) + list(jf[8:])]
    tinfo = [tsys.process_features(f) for f in list(tf[:5]) + list(gt) + list(tf[8:])]
    assert tinfo == jinfo
    assert [i for i, inf in enumerate(tinfo) if not inf["keyframe"]] == [5, 6, 7]
    assert tsys.reloc.misses == 0
    _same_state(tsys, jsys)
    _, chunked = _systems(scene)
    cinfo = chunked.process_features_batch(
        TFeatures(*[torch.stack(x) for x in zip(*(list(tf[:5]) + list(gt) + list(tf[8:])))]))
    assert [i["keyframe"] for i in cinfo] == [i["keyframe"] for i in tinfo]
    assert len(chunked.keyframes) == 7


def test_reloc_reanchors_like_jax():
    """``tests/test_reloc.py:110-146``: after two garbage frames the camera
    resumes far from the last keyframe and near older ones.  The port's
    chunked path re-anchors at the same keyframe, with the same inliers
    and track ids, as the JAX package's per-frame path (the two paths
    agree without BA, ``tests/test_slam_e2e.py:155-189``), then runs the
    rest of the chunk (frame 27) against the new anchor; ``prewarm_reloc``
    before the gap changes nothing."""
    scene, jf, tf = _outward_ring()
    main = list(range(0, 33, 2))
    gj, gt = zip(*[_garbage(10 + s) for s in range(2)])
    jsys, tsys = _systems(scene, reloc_after=2, reloc_window=6)
    jinfo = [jsys.process_features(jf[i]) for i in main]
    jinfo += [jsys.process_features(g) for g in gj] + [jsys.process_features(jf[25])]
    assert jinfo[-1]["reloc"] and jinfo[-1]["anchor"] in (12, 13), jinfo[-1]
    tinfo = tsys.process_features_batch(TFeatures(*[torch.stack(x) for x in zip(*[tf[i] for i in main])]))
    tsys.prewarm_reloc()       # a warm-up query whose results are dropped
    tinfo += tsys.process_features_batch(
        TFeatures(*[torch.stack(x) for x in zip(*(list(gt) + [tf[25], tf[27]]))]))
    assert tinfo[:-1] == jinfo
    assert tinfo[-1]["keyframe"] and "reloc" not in tinfo[-1]
    assert len(tsys.keyframes) == len(jsys.keyframes) + 1
    for a, b in zip(tsys.keyframes, jsys.keyframes):
        np.testing.assert_array_equal(a.track_ids[a.track_ids < jsys._next_track],
                                      b.track_ids[a.track_ids < jsys._next_track])
    np.testing.assert_allclose(tsys.trajectory()[:-1], jsys.trajectory(), atol=1e-3)


# ---------------------------------------------------------------------------
# Checkpoints and global BA
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX system after frames 0-4 of an 8-camera orbit, checkpointed."""
    scene, jf, tf = _orbit(8)
    jsys, _ = _systems(scene)
    for f in jf[:5]:
        jsys.process_features(f)
    path = str(tmp_path_factory.mktemp("ckpt") / "jax_slam")
    jckpt.save_slam_state(path, jsys)
    return scene, jf, tf, jsys, path


def test_jax_checkpoint_loads_and_resumes(jax_run, tmp_path):
    scene, jf, tf, jsys, path = jax_run
    _, tsys = _systems(scene)
    load_slam_state(path, tsys)
    _same_state(tsys, jsys, atol=1e-6)
    np.testing.assert_array_equal(tsys.track_positions, jsys.track_positions)
    assert tsys._next_track == jsys._next_track
    # The port's own round trip, and the JAX package reading it.
    own = str(tmp_path / "port_slam")
    save_slam_state(own, tsys)
    _, again = _systems(scene)
    load_slam_state(own, again)
    np.testing.assert_allclose(again.trajectory(), tsys.trajectory(), atol=1e-6)
    jback, _ = _systems(scene)
    jckpt.load_slam_state(own, jback)
    np.testing.assert_allclose(jback.trajectory(), tsys.trajectory(), atol=1e-6)
    # Resuming: the restored system tracks the next frame as the JAX one.
    jresumed, _ = _systems(scene)
    jckpt.load_slam_state(path, jresumed)
    assert tsys.process_features(tf[5]) == jresumed.process_features(jf[5])
    _same_state(tsys, jresumed)


@pytest.mark.parametrize("use_cg", [None, True], ids=["auto_dense", "cg"])
def test_global_ba_matches_jax(jax_run, use_cg):
    """``SlamSystem.global_ba`` on the same map (the JAX checkpoint loaded
    into both): the same return value, poses within 1e-3, landmarks
    within 1e-2."""
    scene, jf, tf, _, path = jax_run
    jsys, tsys = _systems(scene)
    jckpt.load_slam_state(path, jsys)
    load_slam_state(path, tsys)
    before = tsys.trajectory()
    assert tsys.global_ba(use_cg=use_cg) is jsys.global_ba(use_cg=use_cg) is True
    assert tsys.last_gba_guard is None
    assert np.abs(tsys.trajectory() - before).max() > 1e-5
    _same_state(tsys, jsys)
    np.testing.assert_allclose(tsys.track_positions, jsys.track_positions, atol=1e-2)
