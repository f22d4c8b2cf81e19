"""RANSAC for the essential matrix and the homography in two launches
(``csrc/ransac.cu``).

``hypotheses`` draws, fits and scores every hypothesis of
``geometry.ransac.ransac_plain`` in one launch (one warp a hypothesis);
``refit_winner`` picks the winner, refits it on its inliers and keeps the
better of the two in a second (one block); ``ransac`` runs both.  The wrappers
check their inputs before anything is built, allocate the outputs and the
scratch, launch on the current stream and neither read the device nor
synchronise.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .linalg import _start_on

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "nm_ransac_hypotheses": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
    "nm_ransac_refit": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I,
                        _I, _P],
}
MODELS = {"essential": 0, "homography": 1}    # csrc/ransac.cu's ESSENTIAL, HOMOGRAPHY
SWEEPS = 12        # geometry.linalg.svd3x3's default, as every fitter calls it
ITERATIONS = 8     # geometry.linalg.smallest_eigvec's default, likewise


def _check(src, dst, mask, model):
    """The points' count N, or raise unless ``src`` / ``dst`` are (N, 2)
    float32 and ``mask`` (N,) bool contiguous tensors on one CUDA device,
    N >= 1, and ``model`` is one the kernels fit."""
    if model not in MODELS:
        raise ValueError(f"the RANSAC kernels fit {sorted(MODELS)}, got {model!r}")
    n = src.shape[0] if src.dim() == 2 else 0
    if n < 1:
        raise ValueError(f"src: expected (N, 2) with N >= 1, got {tuple(src.shape)}")
    for name, t, dtype, shape in (("src", src, torch.float32, (n, 2)),
                                  ("dst", dst, torch.float32, (n, 2)),
                                  ("mask", mask, torch.bool, (n,))):
        _build.require_cuda(name, t, dtype, shape)
        if t.device != src.device:
            raise ValueError(f"{name}: on {t.device}, src on {src.device}")
    return n


def hypotheses(src, dst, mask, scores, tau: float, model: str):
    """Every hypothesis of the (I, N) float32 draw ``scores``: its model
    (I, 9), row-major, and its key (I,), E's live inlier count or H's MSAC
    score (+inf unless live)."""
    n = _check(src, dst, mask, model)
    iters = scores.shape[0] if scores.dim() == 2 else 0
    if iters < 1:
        raise ValueError(f"scores: expected (I, {n}) with I >= 1, got {tuple(scores.shape)}")
    _build.require_cuda("scores", scores, torch.float32, (iters, n))
    if scores.device != src.device:
        raise ValueError(f"scores: on {scores.device}, src on {src.device}")
    kw = dict(dtype=torch.float32, device=src.device)
    models, keys = torch.empty((iters, 9), **kw), torch.empty((iters,), **kw)
    lib = _build.load("ransac", _SIGNATURES)
    rc = lib.nm_ransac_hypotheses(
        src.data_ptr(), dst.data_ptr(), mask.data_ptr(), scores.data_ptr(),
        _start_on(src.device, 9).data_ptr(), models.data_ptr(), keys.data_ptr(), n, iters,
        MODELS[model], tau, SWEEPS, ITERATIONS, _build.stream_ptr(src))
    _build.check(rc, "ransac_hypotheses")
    _build.LAUNCHES["ransac_hypotheses"] += 1
    return models, keys


def refit_winner(src, dst, mask, models, keys, tau: float, model: str,
                 refit: bool = True):
    """The winner of ``hypotheses``' output, refitted on its inliers when
    ``refit``: ``(transform (3, 3), inliers (N,) bool, num_inliers () int32,
    success () bool)``."""
    n = _check(src, dst, mask, model)
    iters = keys.shape[0] if keys.dim() == 1 else 0
    if iters < 1:
        raise ValueError(f"keys: expected (I,) with I >= 1, got {tuple(keys.shape)}")
    _build.require_cuda("models", models, torch.float32, (iters, 9))
    _build.require_cuda("keys", keys, torch.float32, (iters,))
    dev = src.device
    transform = torch.empty((3, 3), dtype=torch.float32, device=dev)
    inliers = torch.empty((n,), dtype=torch.bool, device=dev)
    num = torch.empty((), dtype=torch.int32, device=dev)
    success = torch.empty((), dtype=torch.bool, device=dev)
    lib = _build.load("ransac", _SIGNATURES)
    rc = lib.nm_ransac_refit(
        src.data_ptr(), dst.data_ptr(), mask.data_ptr(), _start_on(dev, 9).data_ptr(),
        models.data_ptr(), keys.data_ptr(), transform.data_ptr(), inliers.data_ptr(),
        num.data_ptr(), success.data_ptr(), n, iters, MODELS[model], tau, int(refit),
        SWEEPS, ITERATIONS, _build.stream_ptr(src))
    _build.check(rc, "ransac_refit")
    _build.LAUNCHES["ransac_refit"] += 1
    return transform, inliers, num, success


def ransac(src, dst, mask, scores, tau: float, model: str, refit: bool = True):
    """All of ``ransac_plain`` for "essential" or "homography" in two
    launches: ``(transform, inliers, num_inliers, success)``."""
    models, keys = hypotheses(src, dst, mask, scores, tau, model)
    return refit_winner(src, dst, mask, models, keys, tau, model, refit)
