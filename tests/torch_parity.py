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
