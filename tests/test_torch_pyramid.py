"""The port's pyramid, keypoint detection and keypoint merge against the
JAX package (``niftymatch_torch/ops/{filters,gradients,pyramid,keypoints}``,
``sift._merge_keypoints``).  Pixel values are on the 0-255 scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niftymatch_torch.ops import filters as t_filters
from niftymatch_torch.ops.keypoints import Keypoints
from niftymatch_torch.ops.keypoints import detect_keypoints as t_detect
from niftymatch_torch.ops.pyramid import build_pyramid as t_build_pyramid
from niftymatch_torch.ops.pyramid import stack_gradients as t_stack_gradients
from niftymatch_torch.sift import _merge_keypoints as t_merge
from niftymatch_tpu.config import SiftConfig
from niftymatch_tpu.ops import filters as j_filters
from niftymatch_tpu.ops.keypoints import detect_keypoints as j_detect
from niftymatch_tpu.ops.pyramid import build_pyramid as j_build_pyramid
from niftymatch_tpu.ops.pyramid import stack_gradients as j_stack_gradients
from niftymatch_tpu.sift import _merge_keypoints as j_merge
from torch_parity import bench_scene, np_, port_config, structured_image

H, W = 96, 128
JCFG = SiftConfig(width=W, height=H, max_keypoints_per_level=64, max_features=256)
TCFG = port_config(JCFG)

_j_pyramid = jax.jit(lambda im: j_build_pyramid(im, JCFG))


def _images(test_image):
    return {
        "test_image": test_image.astype(np.float32),
        "bench_crop": bench_scene(480, 640, seed=3)[200 : 200 + H, 300 : 300 + W],
        "structured": structured_image(H, W, seed=2),
    }


def test_gaussian_taps_equal():
    for sigma in (0.8, 1.2263, 3.2):
        np.testing.assert_array_equal(
            t_filters.gaussian_kernel_1d(sigma), j_filters.gaussian_kernel_1d(sigma)
        )


def test_convolve_and_downsample_match_jax(rng):
    img = rng.uniform(0, 255, (2, 37, 53)).astype(np.float32)
    taps = j_filters.gaussian_kernel_1d(1.6)
    got = t_filters.convolve_separable(torch.from_numpy(img), taps)
    want = j_filters.convolve_separable(jnp.asarray(img), taps)
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=1e-4)
    np.testing.assert_array_equal(
        np_(t_filters.downsample_by_2(torch.from_numpy(img))),
        np.asarray(j_filters.downsample_by_2(jnp.asarray(img))),
    )


@pytest.mark.parametrize("which", ["test_image", "bench_crop"])
def test_pyramid_levels_match_jax(test_image, which):
    img = _images(test_image)[which]
    jo = _j_pyramid(jnp.asarray(img))
    to = t_build_pyramid(torch.from_numpy(img), TCFG)
    assert len(jo) == len(to) == JCFG.num_octaves
    for o, (j, t) in enumerate(zip(jo, to)):
        for field in ("gauss", "dog"):
            np.testing.assert_allclose(
                np_(getattr(t, field)), np.asarray(getattr(j, field)),
                atol=1e-4, err_msg=f"octave {o} {field}",
            )
        _assert_polar_close(np_(t.grad), np.asarray(j.grad), f"octave {o}")
    _assert_polar_close(np_(t_stack_gradients(to)),
                        np.asarray(j_stack_gradients(jo)), "stack")


def _assert_polar_close(got, want, err_msg):
    """Magnitudes within 1e-4 everywhere; angles within 1e-4 (mod 2 pi)
    where the magnitude is at least 1.  The angle of a smaller gradient
    moves by (last-bit change of the Gaussian level) / magnitude, and XLA
    may fuse the blur's multiply-adds differently from one compilation to
    the next, so its last bits are not the JAX package's to promise."""
    np.testing.assert_allclose(got[..., 0], want[..., 0], atol=1e-4,
                               err_msg=f"{err_msg} magnitude")
    strong = want[..., 0] >= 1.0
    assert strong.sum() > 100
    d = np.abs(got[..., 1] - want[..., 1])[strong]
    d = np.minimum(d, 2 * np.pi - d)
    assert d.max() <= 1e-4, f"{err_msg} angle: max diff {d.max():.3g}"


def _kp_sorted(kp, level):
    """(x, y, sigma, response) of the valid keypoints of one level, sorted."""
    v = np_(kp.valid)[level]
    cols = [np_(getattr(kp, f))[level][v] for f in ("x", "y", "sigma", "response")]
    order = np.lexsort((cols[1], cols[0]))
    return [c[order] for c in cols]


@pytest.mark.parametrize("which", ["test_image", "bench_crop", "structured"])
def test_detect_keypoints_match_jax(test_image, which):
    """Same DoG stacks in, the same valid keypoint sets out."""
    img = _images(test_image)[which]
    jo = _j_pyramid(jnp.asarray(img))
    total = 0
    for o, data in enumerate(jo):
        jk = j_detect(data.dog, o, JCFG)
        tk = t_detect(torch.from_numpy(np.array(data.dog)), o, TCFG)
        np.testing.assert_array_equal(
            np_(tk.valid).sum(-1), np.asarray(jk.valid).sum(-1), err_msg=f"octave {o}"
        )
        np.testing.assert_array_equal(np_(tk.level), np.asarray(jk.level))
        for lvl in range(JCFG.num_dog_levels):
            for got, want, name in zip(_kp_sorted(tk, lvl), _kp_sorted(jk, lvl),
                                       ("x", "y", "sigma", "response")):
                np.testing.assert_allclose(got, want, atol=1e-4,
                                           err_msg=f"octave {o} level {lvl} {name}")
        total += int(np.asarray(jk.valid).sum())
    assert total >= 8


def test_detect_keypoints_with_mask_match_jax(test_image):
    img = test_image.astype(np.float32)
    mask = np.zeros((H, W), np.float32)
    mask[:, : W // 2] = 1.0
    jo = _j_pyramid(jnp.asarray(img))
    for o, data in enumerate(jo):
        jk = j_detect(data.dog, o, JCFG, mask_image=jnp.asarray(mask))
        tk = t_detect(torch.from_numpy(np.array(data.dog)), o, TCFG,
                      mask_image=torch.from_numpy(mask))
        np.testing.assert_array_equal(np_(tk.valid).sum(-1),
                                      np.asarray(jk.valid).sum(-1))
        assert (np_(tk.x)[np_(tk.valid)] < W // 2 + 1).all()


def test_merge_keypoints_match_jax(test_image):
    """The JAX keypoints carried across merge to the same global top-M,
    slot for slot (ties in lax.top_k order)."""
    jo = _j_pyramid(jnp.asarray(test_image.astype(np.float32)))
    jk = [j_detect(d.dog, o, JCFG) for o, d in enumerate(jo)]
    tk = [Keypoints(*[torch.from_numpy(np.array(a)) for a in k]) for k in jk]
    for m in (256, 16):
        jcfg = SiftConfig(width=W, height=H, max_keypoints_per_level=64, max_features=m)
        jm = j_merge(jk, jcfg)
        tm = t_merge(tk, port_config(jcfg))
        for name, want in jm.items():
            np.testing.assert_array_equal(np_(tm[name]), np.asarray(want), err_msg=name)


def test_batched_pyramid_and_detection_equal_single(test_image):
    imgs = np.stack([test_image.astype(np.float32),
                     structured_image(H, W, seed=5)])
    batch = t_build_pyramid(torch.from_numpy(imgs), TCFG)
    for b in range(2):
        single = t_build_pyramid(torch.from_numpy(imgs[b]), TCFG)
        for o, (tb, ts) in enumerate(zip(batch, single)):
            np.testing.assert_array_equal(np_(tb.grad[b]), np_(ts.grad))
            kb = t_detect(tb.dog, o, TCFG)
            ks = t_detect(ts.dog, o, TCFG)
            for fb, fs in zip(kb, ks):
                np.testing.assert_array_equal(np_(fb[b]), np_(fs))
