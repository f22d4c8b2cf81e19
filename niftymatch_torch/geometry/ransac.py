"""RANSAC for 2-D transforms and two-view geometry (``geometry/ransac.py``
of the JAX package; ``ransac.cu:29-694`` of the reference).

Every hypothesis is drawn, solved and scored at once on the device, with
no host round trip: each row of an (iterations, N) Gumbel draw picks k
distinct valid points (Gumbel-top-k, as a k-step argmax-and-knockout that
keeps the lowest column among exact ties); the mask-weighted fitters solve
all minimal samples in one batched call; transfer-error models pick the
winner by the MSAC truncated loss ``sum min(err, tau)``, epipolar models by
inlier count; a least-squares refit on the winner's inliers is kept when it
scores no worse.

The draw: the JAX package draws with ``jax.random.gumbel`` from a key made
from ``config.seed``, which a torch ``Generator`` cannot reproduce.  Here
the draw comes from a ``torch.Generator`` on the device seeded with
``config.seed`` (``-log`` of exponential samples), or is passed in as
``scores``; the tests pass in the JAX draw to compare the two packages.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import RansacConfig
from ..utils.precision import f32, resolve_device
from .fivepoint import fit_essential5
from .transforms import (
    fit_essential,
    fit_fundamental,
    fit_homography,
    fit_similarity,
    fit_translation,
    sampson_sq_error,
    transfer_sq_error,
)

MIN_SAMPLES = {
    "translation": 1,   # ransac.cu:529
    "similarity": 2,    # ransac.cu:585
    "homography": 4,    # ransac.cu:643
    "fundamental": 8,
    "essential": 8,
    "essential5": 5,    # the five-point minimal solver (fivepoint.py)
}

_FITTERS = {
    "translation": fit_translation,
    "similarity": fit_similarity,
    "homography": fit_homography,
    "fundamental": fit_fundamental,
    "essential": fit_essential,
    "essential5": fit_essential,   # its refit is the 8-point least squares
}

_EPIPOLAR = ("fundamental", "essential", "essential5")


class RansacResult(NamedTuple):
    """Fixed-shape RANSAC output; every field stays on the device."""

    transform: torch.Tensor    # (3, 3) best model
    inliers: torch.Tensor      # (N,) bool inlier mask under the best model
    num_inliers: torch.Tensor  # () int32
    success: torch.Tensor      # () bool: >= k valid points and >= k inliers


@f32
def align_points(xa, ya, xb, yb, match_indices, a_valid=None, device=None):
    """Matched coordinate pairs as aligned (N, 2) ``src``, ``dst`` and an
    (N,) mask (``ransac.cu:29-59``): row i holds (A_i, B_match[i]);
    unmatched rows are zero and masked out."""
    dev = resolve_device(device)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, device=dev).to(dtype)

    idx = t(match_indices, torch.int64)
    ok = idx >= 0
    if a_valid is not None:
        ok = ok & t(a_valid, torch.bool)
    safe = torch.clamp(idx, min=0)
    src = torch.stack([t(xa), t(ya)], dim=-1)
    dst = torch.stack([torch.gather(t(xb), -1, safe), torch.gather(t(yb), -1, safe)], dim=-1)
    keep = ok[..., None]
    return (torch.where(keep, src, torch.zeros_like(src)),
            torch.where(keep, dst, torch.zeros_like(dst)), ok)


def _gumbel_scores(iterations: int, n: int, seed: int, device) -> torch.Tensor:
    """An (iterations, n) standard Gumbel draw on ``device`` from a
    generator seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    e = torch.empty((iterations, n), dtype=torch.float32, device=device)
    return -torch.log(e.exponential_(generator=gen))


def _sample_weights(scores: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """(I, N) 0/1 weights, k distinct valid points a row: the k largest
    masked scores, lowest column first among exact ties.  A row with fewer
    than k valid points gets fewer ones."""
    neg_inf = float("-inf")
    sc = torch.where(mask[None, :], scores, torch.full_like(scores, neg_inf))
    cols = torch.arange(sc.shape[-1], device=sc.device)
    w = torch.zeros_like(sc)
    for _ in range(k):
        m = sc.amax(dim=-1, keepdim=True)
        hit = (sc == m) & (m > neg_inf)
        first = torch.where(hit, cols, 2 ** 30).amin(dim=-1, keepdim=True)
        hit = hit & (cols == first)
        sc = torch.where(hit, neg_inf, sc)
        w = w + hit.to(torch.float32)
    return w


def _error_fn(model: str):
    return sampson_sq_error if model in _EPIPOLAR else transfer_sq_error


@f32
def ransac(src, dst, mask, config: RansacConfig = RansacConfig(),
           model: str = "homography", scores=None, refit: bool = True,
           device=None) -> RansacResult:
    """Robust fit of ``model`` (a ``MIN_SAMPLES`` key) to aligned (N, 2)
    correspondences with an (N,) validity mask.

    ``config.inlier_threshold`` bounds the squared error (``ransac.h``).
    ``scores`` (optional, (config.iterations, N)) is the Gumbel noise that
    picks the samples; by default it is drawn from ``config.seed``.
    ``refit`` refits by least squares on the winner's inliers."""
    if model not in MIN_SAMPLES:
        raise ValueError(f"model must be one of {sorted(MIN_SAMPLES)}, got {model!r}")
    dev = resolve_device(device)
    src = torch.as_tensor(src, device=dev).to(torch.float32)
    dst = torch.as_tensor(dst, device=dev).to(torch.float32)
    mask = torch.as_tensor(mask, device=dev).to(torch.bool)
    n, iters = src.shape[0], config.iterations
    if scores is None:
        scores = _gumbel_scores(iters, n, config.seed, dev)
    else:
        scores = torch.as_tensor(scores, device=dev).to(torch.float32)
        if tuple(scores.shape) != (iters, n):
            raise ValueError(f"scores: expected shape {(iters, n)}, got {tuple(scores.shape)}")
    k = MIN_SAMPLES[model]
    err_fn = _error_fn(model)
    fitter = _FITTERS[model]

    weights = _sample_weights(scores, mask, k)
    live = weights.sum(-1) >= k
    if model == "essential5":
        cand, cand_valid = fit_essential5(src, dst, weights)   # (I, 10, 3, 3)
        models = cand.reshape(-1, 3, 3)
        live = live.repeat_interleave(10) & cand_valid.reshape(-1)
    else:
        models = fitter(src.expand(iters, n, 2), dst.expand(iters, n, 2), weights)

    errs = err_fn(models, src[None], dst[None])
    tau = config.inlier_threshold
    is_inlier = (errs < tau) & mask[None, :]
    use_msac = model not in _EPIPOLAR
    zero = torch.zeros((), device=dev)
    if use_msac:
        msac = torch.where(mask[None, :], torch.clamp(errs, max=tau), zero).sum(-1)
        msac = torch.where(live, msac, float("inf"))
        best = torch.argmin(msac)
    else:
        best = torch.argmax(is_inlier.sum(-1) * live)

    # Index with a 1-element tensor: a 0-dim tensor index is read on the
    # host (a synchronisation on CUDA).
    best = best.reshape(1)
    transform = models.index_select(0, best)[0]
    inliers = is_inlier.index_select(0, best)[0]
    if refit and model != "translation":
        refit_w = inliers.to(torch.float32)
        refitted = fitter(src, dst, refit_w)
        transform = torch.where(refit_w.sum() >= k, refitted, transform)
        re_err = err_fn(transform, src, dst)
        re_inl = (re_err < tau) & mask
        if use_msac:
            re_score = torch.where(mask, torch.clamp(re_err, max=tau), zero).sum()
            keep = re_score <= msac.index_select(0, best)[0]
        else:
            keep = re_inl.sum() >= inliers.sum()
        transform = torch.where(keep, transform, models.index_select(0, best)[0])
        inliers = torch.where(keep, re_inl, inliers)

    num = inliers.sum(dtype=torch.int32)
    success = (mask.sum() >= k) & (num >= k)
    return RansacResult(transform=transform, inliers=inliers,
                        num_inliers=num, success=success)
