"""The port's whole slice (``niftymatch_torch/sift.py``: detect, describe,
match) against the JAX package's ``detect_and_describe`` and
``match_pair``, on the CPU through the kernels' plain versions.

Tolerances are those of ``tests/test_pallas_windows.py:60-70``: x, y,
sigma, angle and response within 1e-4, descriptors within 2e-3, valid
counts equal, compared sorted by (x, y); the batched path equals the
single-image one within 1e-5.
"""

import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import niftymatch_torch as nt
from niftymatch_torch.convert import pipeline_config_from_dict
from niftymatch_tpu.config import PipelineConfig, SiftConfig
from niftymatch_tpu.sift import (
    detect_and_describe,
    detect_and_describe_per_octave,
    match_pair,
)
from torch_parity import bench_scene, np_, port_config, sorted_valid, structured_image

H, W = 96, 128
JCFG = SiftConfig(width=W, height=H, max_keypoints_per_level=64, max_features=256)
REPO = Path(__file__).resolve().parent.parent


@functools.lru_cache(maxsize=None)
def _jax_features(seed: int):
    img = structured_image(H, W, seed=seed)
    return img, jax.device_get(jax.jit(lambda x: detect_and_describe(x, JCFG))(
        jnp.asarray(img)))


def _assert_features_close(tf, jf, desc_atol=2e-3, atol=1e-4):
    vt, ot = sorted_valid(tf.valid, tf.x, tf.y)
    vj, oj = sorted_valid(jf.valid, jf.x, jf.y)
    assert vt.sum() == vj.sum() > 10
    for field in ("x", "y", "sigma", "angle", "response"):
        np.testing.assert_allclose(np_(getattr(tf, field))[vt][ot],
                                   np_(getattr(jf, field))[vj][oj],
                                   atol=atol, err_msg=field)
    for field in ("octave", "level"):
        np.testing.assert_array_equal(np_(getattr(tf, field))[vt][ot],
                                      np_(getattr(jf, field))[vj][oj], err_msg=field)
    np.testing.assert_allclose(np_(tf.desc)[vt][ot], np_(jf.desc)[vj][oj],
                               atol=desc_atol, err_msg="desc")


@pytest.mark.parametrize("seed", [2, 5])
def test_detect_and_describe_matches_jax(seed):
    img, jf = _jax_features(seed)
    tf = nt.detect_and_describe(img, port_config(JCFG), device="cpu")
    assert tf.desc.shape == (JCFG.max_features, 128)
    _assert_features_close(tf, jf)
    np.testing.assert_array_equal(np_(tf.desc)[~np_(tf.valid)], 0.0)


def test_masked_detect_matches_jax():
    img = structured_image(H, W, seed=2)
    mask = np.zeros((H, W), np.float32)
    mask[:, 16:112] = 1.0
    jf = jax.device_get(jax.jit(lambda x, m: detect_and_describe(x, JCFG, mask=m))(
        jnp.asarray(img), jnp.asarray(mask)))
    detect = nt.make_detector(port_config(JCFG), masked=True, device="cpu")
    _assert_features_close(detect(img, mask), jf)


def test_batch_equals_single():
    imgs = np.stack([structured_image(H, W, seed=s) for s in (3, 9)])
    cfg = port_config(JCFG)
    fb = nt.make_batch_detector(cfg, device="cpu")(imgs)
    single = nt.make_detector(cfg, device="cpu")
    for b in range(2):
        f1 = single(imgs[b])
        vb, ob = sorted_valid(fb.valid[b], fb.x[b], fb.y[b])
        v1, o1 = sorted_valid(f1.valid, f1.x, f1.y)
        assert vb.sum() == v1.sum() > 10
        for field in ("x", "desc", "angle"):
            np.testing.assert_allclose(np_(getattr(fb, field)[b])[vb][ob],
                                       np_(getattr(f1, field))[v1][o1], atol=1e-5)


def test_second_orientation_matches_jax():
    jcfg = dataclasses.replace(JCFG, use_second_orientation=True)
    img = structured_image(H, W, seed=2)
    jf = jax.device_get(jax.jit(lambda x: detect_and_describe(x, jcfg))(jnp.asarray(img)))
    tf = nt.detect_and_describe(img, port_config(jcfg), device="cpu")
    _assert_features_close(tf, jf)


def test_pair_pipeline_matches_jax_match_pair():
    scene = bench_scene(H, W, seed=1, n_blobs=30)
    img_a, img_b = scene[:H, :W], scene[5 : H + 5, 5 : W + 5]
    jcfg = PipelineConfig(sift=JCFG)
    fa = jax.jit(lambda x: detect_and_describe(x, JCFG))(jnp.asarray(img_a))
    fb = jax.jit(lambda x: detect_and_describe(x, JCFG))(jnp.asarray(img_b))
    jmatch = match_pair(fa, fb)
    run = nt.make_pair_pipeline(pipeline_config_from_dict(dataclasses.asdict(jcfg)),
                                device="cpu")
    ta, tb, tmatch = run(img_a, img_b)
    _assert_features_close(ta, jax.device_get(fa))
    _assert_features_close(tb, jax.device_get(fb))
    # Slots may be ordered differently where responses tie to the last bit:
    # compare matches as (x, y) coordinate pairs of the two images.
    def pairs(f_a, f_b, idx):
        idx = np_(idx)
        ok = (idx >= 0) & np_(f_a.valid)
        return sorted(zip(np_(f_a.x)[ok].round(3), np_(f_a.y)[ok].round(3),
                          np_(f_b.x)[idx[ok]].round(3), np_(f_b.y)[idx[ok]].round(3)))
    want = pairs(fa, fb, jmatch.indices)
    assert len(want) > 10
    assert pairs(ta, tb, tmatch.indices) == want
    dx = [p[2] - p[0] for p in want]
    assert np.median(dx) == pytest.approx(-5.0, abs=0.01)


def _by_angle_y_x(f):
    """Valid mask and the order of ``tests/test_sift_e2e.py:92-93``."""
    v = np_(f.valid).astype(bool)
    return v, np.lexsort((np_(f.angle)[v], np_(f.y)[v], np_(f.x)[v]))


def _assert_same_feature_set(a, b):
    """``tests/test_sift_e2e.py:90-103``: the same valid count, every field
    and the descriptors within 1e-4, sorted by (x, y, angle)."""
    va, oa = _by_angle_y_x(a)
    vb, ob = _by_angle_y_x(b)
    assert va.sum() == vb.sum() > 10
    for field in ("x", "y", "sigma", "angle", "response", "desc"):
        np.testing.assert_allclose(np_(getattr(a, field))[va][oa],
                                   np_(getattr(b, field))[vb][ob], atol=1e-4,
                                   err_msg=field)
    for field in ("octave", "level"):
        np.testing.assert_array_equal(np_(getattr(a, field))[va][oa],
                                      np_(getattr(b, field))[vb][ob], err_msg=field)


@pytest.mark.parametrize("case", ["first", "second", "masked"])
def test_per_octave_matches_jax_and_merged(case):
    """The port's per-octave oracle against the JAX one, and against the
    port's merged path, at 96x128 (``tests/test_sift_e2e.py:74-103``)."""
    jcfg = dataclasses.replace(JCFG, use_second_orientation=case == "second")
    img = structured_image(H, W, seed=7)
    mask = None
    if case == "masked":
        mask = np.zeros((H, W), np.float32)
        mask[:, 20:100] = 1.0
    jf = jax.device_get(jax.jit(
        lambda x, m: detect_and_describe_per_octave(x, jcfg, mask=m))(
            jnp.asarray(img), None if mask is None else jnp.asarray(mask)))
    tcfg = port_config(jcfg)
    tf = nt.sift.detect_and_describe_per_octave(img, tcfg, mask=mask, device="cpu")
    assert tf.desc.shape == (jcfg.max_features, 128)
    _assert_same_feature_set(tf, jf)
    merged = nt.detect_and_describe(img, tcfg, mask=mask, device="cpu")
    _assert_same_feature_set(tf, merged)


def test_port_imports_no_jax():
    code = (
        "import sys, chip_smoke, niftymatch_torch, niftymatch_torch.convert;"
        "import niftymatch_torch.kernels.windows, niftymatch_torch.kernels.match;"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'niftymatch_tpu')];"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_config(JCFG)
    img = np.zeros((H, W), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        nt.detect_and_describe(img, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        nt.make_pair_pipeline(nt.PipelineConfig(sift=cfg))
    with pytest.raises(RuntimeError, match="CUDA"):
        nt.make_batch_detector(cfg)
    f = nt.Features.empty(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        nt.match_pair(f, f)
    with pytest.raises(RuntimeError, match="CUDA"):
        nt.sift.detect_and_describe_per_octave(img, cfg)
