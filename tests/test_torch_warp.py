"""The port's pixel-format and warp ops (``niftymatch_torch/ops/image.py``,
``ops/warp.py``) against the JAX package's, on the CPU, within 1e-5 of
each result's largest magnitude (exact for the integer ops)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niftymatch_torch.ops import image as ti
from niftymatch_torch.ops import warp as tw
from niftymatch_tpu.ops import image as ji
from niftymatch_tpu.ops import warp as jw
from torch_parity import np_

H_SHIFT = np.array([[0.98, 0.05, 3.5], [-0.04, 1.02, -2.25], [1e-4, -2e-4, 1.0]],
                   np.float32)


def _close(got, want, rel=1e-5):
    got, want = np_(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=rel * max(1.0, np.abs(want).max()))


def _image(rng, shape):
    return rng.uniform(0, 255, shape).astype(np.float32)


def _bgra(rng):
    return rng.integers(0, 256, (9, 11, 4), dtype=np.uint8)


def test_bgra_to_gray_and_channels_match_jax(rng):
    bgra = _bgra(rng)
    t, j = torch.from_numpy(bgra), jnp.asarray(bgra)
    _close(ti.bgra_to_gray(t), ji.bgra_to_gray(j))
    for c in range(4):
        _close(ti.extract_channel(t, c), ji.extract_channel(j, c))
    values = rng.integers(0, 256, (9, 11)).astype(np.uint8)
    for c in (1, 3):
        np.testing.assert_array_equal(
            np_(ti.put_channel(t, torch.from_numpy(values), c)),
            np.asarray(ji.put_channel(j, jnp.asarray(values), c)))
    np.testing.assert_array_equal(np_(ti.set_alpha(t, 17)), np.asarray(ji.set_alpha(j, 17)))
    np.testing.assert_array_equal(np_(t), bgra)      # inputs left as they were


def test_cast_transpose_subtract_match_jax(rng):
    x = rng.uniform(0, 300, (7, 5)).astype(np.float32)
    t, j = torch.from_numpy(x), jnp.asarray(x)
    for max_val in (0, 200):
        np.testing.assert_array_equal(np_(ti.cast_saturate(t, torch.int32, max_val)),
                                      np.asarray(ji.cast_saturate(j, jnp.int32, max_val)))
    np.testing.assert_array_equal(np_(ti.transpose_2d(t)), np.asarray(ji.transpose_2d(j)))
    _close(ti.subtract_images(t, t.flip(0)), ji.subtract_images(j, j[::-1]))


def test_undistort_map_and_remap_match_jax(rng):
    cam, dist = (60.0, 58.0, 31.5, 23.0), (-0.21, 0.05, -0.004)
    tc, td = torch.tensor(cam), torch.tensor(dist)
    maps_t = tw.undistort_map(tc, td, 48, 64)
    maps_j = jw.undistort_map(jnp.asarray(cam, jnp.float32), jnp.asarray(dist, jnp.float32),
                              48, 64)
    for a, b in zip(maps_t, maps_j):
        _close(a, b)
    img = _image(rng, (48, 64))
    _close(tw.remap(torch.from_numpy(img), *maps_t),
           jw.remap(jnp.asarray(img), *map(jnp.asarray, map(np_, maps_t))))


@pytest.mark.parametrize("channels", [None, 3])
def test_bilinear_sample_matches_jax(rng, channels):
    """Coordinates inside, on the border, outside and far outside."""
    shape = (20, 30) if channels is None else (20, 30, channels)
    img = _image(rng, shape)
    x = rng.uniform(-3, 33, (17, 13)).astype(np.float32)
    y = rng.uniform(-3, 23, (17, 13)).astype(np.float32)
    x[0, :4] = [-1e6, 1e6, 29.0, -0.5]
    y[1, :4] = [-1e6, 1e6, 19.0, -0.5]
    _close(tw.bilinear_sample(torch.from_numpy(img), torch.from_numpy(x), torch.from_numpy(y)),
           jw.bilinear_sample(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("channels", [None, 3])
def test_warp_perspective_matches_jax(rng, inverse, channels):
    shape = (24, 32) if channels is None else (24, 32, channels)
    img = _image(rng, shape)
    th, jh = torch.from_numpy(H_SHIFT), jnp.asarray(H_SHIFT)
    for a, b in zip(tw.perspective_coords(th, 20, 36, inverse),
                    jw.perspective_coords(jh, 20, 36, inverse)):
        _close(a, b)
    _close(tw.warp_perspective(torch.from_numpy(img), th, (20, 36), inverse),
           jw.warp_perspective(jnp.asarray(img), jh, (20, 36), inverse))
    _close(tw.warp_perspective(torch.from_numpy(img), th, inverse=inverse),
           jw.warp_perspective(jnp.asarray(img), jh, inverse=inverse))


def test_warp_mask_matches_jax(rng):
    mask = (rng.uniform(size=(20, 30)) > 0.4).astype(np.float32)
    mx, my = jw.perspective_coords(jnp.asarray(H_SHIFT), 20, 30)
    got = tw.warp_mask(torch.from_numpy(mask), torch.from_numpy(np.asarray(mx)),
                       torch.from_numpy(np.asarray(my)), 0.3)
    want = jw.warp_mask(jnp.asarray(mask), mx, my, 0.3)
    np.testing.assert_array_equal(np_(got), np.asarray(want))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("channels", [None, 3])
def test_blend_into_mosaic_matches_jax(rng, masked, channels):
    """Two frames blended in turn into a canvas, with and without a frame
    mask, grayscale and three-channel."""
    extra = () if channels is None else (channels,)
    canvas = np.zeros((40, 56) + extra, np.float32)
    weights = np.zeros((40, 56), np.float32)
    frames = [_image(rng, (24, 32) + extra) for _ in range(2)]
    fw = rng.uniform(0.1, 1.0, (24, 32)).astype(np.float32)
    fw[0, :5] = 0.0
    mask = (rng.uniform(size=(24, 32)) > 0.3).astype(np.float32) if masked else None
    homs = [np.array([[1, 0, -6.0], [0, 1, -5.0], [0, 0, 1]], np.float32),
            np.linalg.inv(H_SHIFT).astype(np.float32) @ np.array(
                [[1, 0, -14.0], [0, 1, -9.0], [0, 0, 1]], np.float32)]
    tc, tws = torch.from_numpy(canvas), torch.from_numpy(weights)
    jc, jws = jnp.asarray(canvas), jnp.asarray(weights)
    for frame, h in zip(frames, homs):
        tc, tws = tw.blend_into_mosaic(tc, tws, torch.from_numpy(frame), torch.from_numpy(fw),
                                       torch.from_numpy(h),
                                       None if mask is None else torch.from_numpy(mask))
        jc, jws = jw.blend_into_mosaic(jc, jws, jnp.asarray(frame), jnp.asarray(fw),
                                       jnp.asarray(h), None if mask is None else jnp.asarray(mask))
        _close(tc, jc)
        _close(tws, jws)
    assert (np_(tws) > 0).sum() > 24 * 32
