"""The port's mosaic builder (``niftymatch_torch/mosaic.py``) on the CPU,
against the truth and against the JAX package's ``MosaicBuilder``.

Four 96x128 crops of one scene at known shifts are registered in turn:
every frame registers, the final frame-to-canvas chain sends the frame's
corners within 1 px of the truth and of the JAX chain, and the canvas
matches the scene where it is covered (median |difference| < 2 on the
0-255 scale)."""

import functools

import numpy as np
import pytest
import torch

from niftymatch_torch.config import RansacConfig as TRansacConfig
from niftymatch_torch.mosaic import MosaicBuilder, MosaicConfig
from niftymatch_tpu.config import RansacConfig as JRansacConfig
from niftymatch_tpu.mosaic import MosaicBuilder as JMosaicBuilder
from niftymatch_tpu.mosaic import MosaicConfig as JMosaicConfig
from torch_parity import dense_blob_scene

H, W = 96, 128
SHIFTS = [(0, 0), (10, 14), (20, 28), (30, 42)]
ANCHOR = (40.0, 30.0)
SETTINGS = dict(width=W, height=H, canvas_width=256, canvas_height=192,
                anchor_x=ANCHOR[0], anchor_y=ANCHOR[1], detector_features=256)


@functools.lru_cache(maxsize=None)
def _scene():
    return dense_blob_scene(140, 180)


def _frames():
    scene = _scene()
    return [scene[dy:dy + H, dx:dx + W] for dy, dx in SHIFTS]


def _corners(hom):
    c = np.array([[0, 0, 1], [W - 1, 0, 1], [0, H - 1, 1], [W - 1, H - 1, 1]], float).T
    p = hom @ c
    return (p[:2] / p[2]).T


def test_mosaic_registers_crops_like_jax():
    frames = _frames()
    tb = MosaicBuilder(MosaicConfig(**SETTINGS), device="cpu")
    infos = [tb.add_frame(f) for f in frames]
    assert all(i["registered"] for i in infos), infos
    assert tb.num_failed == 0 and min(i["num_inliers"] for i in infos[1:]) > 20
    dy, dx = SHIFTS[-1]
    truth = _corners(np.array([[1, 0, ANCHOR[0] + dx], [0, 1, ANCHOR[1] + dy], [0, 0, 1.0]]))
    got = _corners(tb.frame_to_canvas())
    np.testing.assert_allclose(got, truth, atol=1.0)

    jb = JMosaicBuilder(JMosaicConfig(**SETTINGS))
    jinfos = [jb.add_frame(f) for f in frames]
    assert all(i["registered"] for i in jinfos)
    np.testing.assert_allclose(got, _corners(jb.frame_to_canvas()), atol=1.0)

    canvas, weights = tb.result(), tb.weights.numpy()
    ys, xs = np.nonzero(weights > 0.2)
    assert len(ys) > 0.8 * H * W
    scene = _scene()
    diff = np.abs(canvas[ys, xs] - scene[ys - int(ANCHOR[1]), xs - int(ANCHOR[0])])
    assert np.median(diff) < 2.0, np.median(diff)


def test_first_frame_with_undistortion_matches_jax():
    """The undistort -> detect -> blend of a first frame, against JAX."""
    cam, dist = (120.0, 118.0, 63.5, 47.5), (-0.08, 0.01, 0.0)
    frame = _frames()[0]
    tb = MosaicBuilder(MosaicConfig(camera_matrix=cam, distortion=dist, **SETTINGS),
                       device="cpu")
    jb = JMosaicBuilder(JMosaicConfig(camera_matrix=cam, distortion=dist, **SETTINGS))
    assert tb.add_frame(frame)["registered"] and jb.add_frame(frame)["registered"]
    np.testing.assert_allclose(tb.result(), jb.result(), atol=1e-3)
    np.testing.assert_allclose(tb.weights.numpy(), np.asarray(jb.weights), atol=1e-5)
    np.testing.assert_allclose(tb.frame_to_canvas(), jb.frame_to_canvas())


def test_mosaic_rejects_unrelated_frame():
    tb = MosaicBuilder(MosaicConfig(ransac=TRansacConfig(iterations=256), **SETTINGS),
                       device="cpu")
    assert tb.add_frame(_frames()[0])["registered"]
    noise = np.random.default_rng(1).normal(128, 30, (H, W)).astype(np.float32)
    info = tb.add_frame(noise)
    assert not info["registered"] and tb.num_failed == 1 and tb.num_registered == 1


def test_mosaic_config_defaults_match_jax():
    t, j = MosaicConfig(width=W, height=H), JMosaicConfig(width=W, height=H)
    assert t.ransac == TRansacConfig(iterations=1024, inlier_threshold=9.0)
    assert j.ransac == JRansacConfig(iterations=1024, inlier_threshold=9.0)
    assert [f.name for f in t.__dataclass_fields__.values()] == [
        f.name for f in j.__dataclass_fields__.values()]


def test_mosaic_builder_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MosaicBuilder(MosaicConfig(width=W, height=H))
