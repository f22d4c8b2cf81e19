"""Shared inputs and checks for the tests that hold the PyTorch port
(``niftymatch_torch``) against the JAX package.

Inputs are made with numpy from a seed and handed to both packages as
numpy arrays.  Whether a CUDA card is present is decided inside a test
(``cuda_device``), never at import, so every test worker collects the
same tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from niftymatch_torch.convert import sift_config_from_dict


def structured_image(h, w, seed=0, n_blobs=25):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w), np.float32)
    for _ in range(n_blobs):
        by, bx = rng.uniform(8, h - 8), rng.uniform(8, w - 8)
        bs = rng.uniform(1.5, 6.0)
        amp = rng.uniform(80, 255) * rng.choice([-1, 1])
        img += amp * np.exp(-((yy - by) ** 2 + (xx - bx) ** 2) / (2 * bs**2))
    return img + 128.0


def bench_scene(h, w, seed=0, n_blobs=120):
    """The blob scene of ``bench.py::make_scene`` ((h + 16, w + 16))."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0 : h + 16, 0 : w + 16].astype(np.float32)
    scene = np.zeros_like(yy)
    for _ in range(n_blobs):
        by, bx = rng.uniform(10, h), rng.uniform(10, w)
        bs = rng.uniform(2, 7)
        amp = rng.uniform(60, 255) * rng.choice([-1.0, 1.0])
        scene += amp * np.exp(-((yy - by) ** 2 + (xx - bx) ** 2) / (2 * bs**2))
    return (scene + 128.0).astype(np.float32)


def dense_blob_scene(h, w, seed=4, n_blobs=300):
    """Many small blobs: ~50 mutual matches between 96x128 crops, enough to
    register them by homography."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.full((h, w), 128.0, np.float32)
    for _ in range(n_blobs):
        by, bx = rng.uniform(0, h), rng.uniform(0, w)
        bs = rng.uniform(1.5, 3.0)
        amp = rng.uniform(60, 255) * rng.choice([-1.0, 1.0])
        img += amp * np.exp(-((yy - by) ** 2 + (xx - bx) ** 2) / (2 * bs**2))
    return img


def port_config(jax_config):
    """The port's SiftConfig carried across from a JAX SiftConfig."""
    return sift_config_from_dict(dataclasses.asdict(jax_config))


def np_(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def sorted_valid(valid, x, y):
    """Valid mask and the order that sorts the valid slots by (x, y)."""
    v = np_(valid).astype(bool)
    order = np.lexsort((np_(y)[v], np_(x)[v]))
    return v, order


def assert_close_up_to_sign(got, want, atol, axis=None):
    """Equal within ``atol`` up to one sign per slice along ``axis``
    (per matrix when None)."""
    got, want = np_(got), np_(want)
    if axis is None:
        d = min(np.abs(got - want).max(), np.abs(got + want).max())
        assert d <= atol, d
        return
    plus = np.abs(got - want).max(axis=axis)
    minus = np.abs(got + want).max(axis=axis)
    assert np.minimum(plus, minus).max() <= atol, np.minimum(plus, minus).max()


def cuda_device():
    """The CUDA device, or skip the calling test when there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: runs the hand-written kernels")
    return torch.device("cuda")


def assert_hist_close(got, want, rel=1e-4, err_msg=""):
    """Histograms agree within ``rel`` times each row's largest |value|:
    only the order of the sums differs between the two versions."""
    got, want = np_(got), np_(want)
    scale = np.maximum(np.abs(want).max(axis=-1, keepdims=True), 1.0)
    bad = np.abs(got - want) > rel * scale
    assert not bad.any(), (
        f"{err_msg}: {bad.any(axis=-1).sum()} rows differ; "
        f"max rel err {(np.abs(got - want) / scale).max():.3g}"
    )


# Truth of the 2-D RANSAC models: well conditioned over [0, 300)^2.
PLANAR_TRUTH = {
    "translation": np.array([[1, 0, 7.0], [0, 1, -2.0], [0, 0, 1]], np.float32),
    "similarity": np.array([[1.1 * np.cos(0.25), -1.1 * np.sin(0.25), 4.0],
                            [1.1 * np.sin(0.25), 1.1 * np.cos(0.25), -6.0],
                            [0, 0, 1]], np.float32),
    "homography": np.array([[1.02, 0.03, 5.0], [-0.02, 0.98, -4.0],
                            [2e-4, -1e-4, 1.0]], np.float32),
}


def planar_correspondences(rng, model, n, outliers):
    """n points in [0, 300)^2 and their images under ``PLANAR_TRUTH[model]``;
    the first ``outliers`` images are replaced by random points."""
    src = rng.uniform(0, 300, size=(n, 2)).astype(np.float32)
    # Well-spread first inliers, so a minimal sample is well conditioned.
    src[outliers:outliers + 4] = [[20, 30], [280, 45], [265, 270], [35, 250]]
    hom = PLANAR_TRUTH[model].astype(np.float64)
    p = np.c_[src, np.ones(n)] @ hom.T
    dst = (p[:, :2] / p[:, 2:]).astype(np.float32)
    dst[:outliers] = rng.uniform(0, 300, size=(outliers, 2)).astype(np.float32)
    return src, dst


def two_view(rng, n, theta=0.25, outliers=0, spread=False):
    """Normalised camera coordinates of n points seen from two poses; with
    ``spread`` the first eight inliers are fixed, well-spread points."""
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    rot = np.eye(3) + np.sin(theta) * k + (1 - np.cos(theta)) * (k @ k)
    t = rng.standard_normal(3)
    t /= np.linalg.norm(t)
    p = rng.uniform(-1, 1, size=(n, 3))
    p[:, 2] += 4.0
    if spread:
        p[outliers:outliers + 8] = [
            (-1.37, -0.51, 5.47), (0.98, -1.32, 6.04), (2.14, -2.43, 6.21),
            (-0.16, 0.52, 3.07), (-1.43, -2.29, 3.88), (-0.89, -0.26, 3.28),
            (2.41, -1.61, 6.73), (2.41, -0.94, 3.66)]
    x1 = p[:, :2] / p[:, 2:3]
    p2 = p @ rot.T + t
    x2 = p2[:, :2] / p2[:, 2:3]
    x2[:outliers] = rng.uniform(-0.5, 0.5, size=(outliers, 2))
    e = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]]) @ rot
    return x1.astype(np.float32), x2.astype(np.float32), e / np.linalg.norm(e)
