"""Orientation assignment from 36-bin gradient histograms
(``ops/orientation.py`` of the JAX package; ``orientation.cu:11-129``).

* window: ``sigma_w = 1.5 s``, ``w_r = min(max(floor(3 sigma_w), 1), 10)``;
  pixels with ``r^2 < w_r^2 + 0.6`` add ``mag * exp(-r^2 / (2 sigma_w^2))``
  (sign flipped under ``compat.flipped_gaussian_sign``) to bin
  ``floor(36 ang / 2pi) mod 36``;
* six synchronous circular [1, 1, 1]/3 smoothing passes;
* the first two strict local maxima above 0.8 max, parabolically
  interpolated.

``_histograms_core`` is also the plain version of kernel K2
(``kernels/windows.py``); ``compute_orientations`` is the per-octave
oracle path (``sift.detect_and_describe_per_octave``).
"""

from __future__ import annotations

import torch

from ..config import NUM_ORI_BINS, SiftConfig
from .gradients import TWO_PI, div_const
from .patches import gather_patches, patch_offsets


def smooth_histogram(hist: torch.Tensor, iterations: int = 6) -> torch.Tensor:
    for _ in range(iterations):
        hist = div_const(
            torch.roll(hist, 1, dims=-1) + hist + torch.roll(hist, -1, dims=-1), 3.0
        )
    return hist


def _histograms_core(mag, ang, x, y, xi, yi, s, valid, radius: int,
                     config: SiftConfig) -> torch.Tensor:
    """Raw (K, 36) histograms from (K, P, P) gradient patches centred on
    the integer pixel (yi, xi) of keypoints at octave coords (y, x)."""
    sigma_w = 1.5 * s
    w_r = torch.clamp(torch.floor(3.0 * sigma_w), min=1.0)
    w_r = torch.clamp(w_r, max=float(radius))[:, None, None]

    off_y, off_x = patch_offsets(radius, mag.device)
    dx = off_x[None] + (xi.to(torch.float32) - x)[:, None, None]
    dy = off_y[None] + (yi.to(torch.float32) - y)[:, None, None]
    r2 = dx * dx + dy * dy

    inside = (
        (torch.abs(off_x)[None] <= w_r)
        & (torch.abs(off_y)[None] <= w_r)
        & (r2 < w_r * w_r + 0.6)
        & valid[:, None, None]
    )
    sign = 1.0 if config.compat.flipped_gaussian_sign else -1.0
    wgt = torch.exp(sign * r2 / (2.0 * sigma_w * sigma_w)[:, None, None])
    weight = torch.where(inside, mag * wgt, torch.zeros_like(mag))

    bins = torch.remainder(
        torch.floor(div_const(NUM_ORI_BINS * ang, TWO_PI)).to(torch.int32),
        NUM_ORI_BINS,
    )
    k = x.shape[0]
    one_hot = torch.nn.functional.one_hot(
        bins.reshape(k, -1).long(), NUM_ORI_BINS
    ).to(torch.float32)
    return torch.einsum("kp,kpb->kb", weight.reshape(k, -1), one_hot)


def pick_peaks(hist: torch.Tensor):
    """First two interpolated peaks in bin order: ``angles`` (..., 2) with
    -1 sentinels and ``valid`` (..., 2)."""
    maxh = hist.max(dim=-1, keepdim=True).values
    threshold = 0.8 * maxh
    hm = torch.roll(hist, 1, dims=-1)
    hp = torch.roll(hist, -1, dims=-1)
    is_peak = (hist > threshold) & (hist > hm) & (hist > hp)

    denom = hp + hm - 2.0 * hist
    di = -0.5 * (hp - hm) / torch.where(denom == 0.0, torch.ones_like(denom), denom)
    idx = torch.arange(hist.shape[-1], dtype=torch.float32, device=hist.device)
    theta = div_const(TWO_PI * (idx + di + 0.5), float(hist.shape[-1]))

    rank = torch.cumsum(is_peak.to(torch.int32), dim=-1)
    first = is_peak & (rank == 1)
    second = is_peak & (rank == 2)
    zero = torch.zeros_like(theta)
    a1 = torch.where(first, theta, zero).sum(dim=-1)
    a2 = torch.where(second, theta, zero).sum(dim=-1)
    has1 = first.any(dim=-1)
    has2 = second.any(dim=-1)
    minus1 = torch.full_like(a1, -1.0)
    angles = torch.stack(
        [torch.where(has1, a1, minus1), torch.where(has2, a2, minus1)], dim=-1
    )
    return angles, torch.stack([has1, has2], dim=-1)


def finish_orientations(hists: torch.Tensor, valid: torch.Tensor):
    """Smoothing + peak picking + validity of raw (M, 36) histograms."""
    angles, avalid = pick_peaks(smooth_histogram(hists))
    avalid = avalid & valid[..., None]
    return torch.where(avalid, angles, torch.full_like(angles, -1.0)), avalid


def octave_coords(x, y, sigma, octave):
    """Input-image keypoint coords -> octave coords and the integer centre
    ``(int)(x + 0.5)``: (xo, yo, so, xi, yi)."""
    xper = torch.exp2(octave.to(torch.float32))
    xo, yo, so = x / xper, y / xper, sigma / xper
    xi = torch.floor(xo + 0.5).to(torch.int32)
    yi = torch.floor(yo + 0.5).to(torch.int32)
    return xo, yo, so, xi, yi


def _histograms_one_level(grad_level, x, y, s, valid, config: SiftConfig):
    """Raw (K, 36) histograms of one level's keypoints (octave coords) from
    its (H, W, 2) gradients.  The window is gathered around the clamped
    centre, and the sub-pixel offsets are taken from the unclamped one, as
    the JAX per-octave path does."""
    radius = config.max_orientation_radius
    xi = torch.floor(x + 0.5).to(torch.int32)
    yi = torch.floor(y + 0.5).to(torch.int32)
    patches = gather_patches(grad_level, yi, xi, radius)
    return _histograms_core(patches[..., 0], patches[..., 1], x, y, xi, yi, s,
                            valid, radius, config)


def compute_orientations(keypoints, grad: torch.Tensor, octave: int,
                         config: SiftConfig):
    """Orientations of one octave's (L, K) keypoints from its (L, H, W, 2)
    gradients, each level reading its own slice (``siftfunctions.cu:136-152``):
    ``angles`` (L, K, 2) with -1 sentinels and ``valid`` (L, K, 2)."""
    xper = float(2.0 ** octave)
    x, y, s = keypoints.x / xper, keypoints.y / xper, keypoints.sigma / xper
    hists = torch.stack([
        _histograms_one_level(grad[l], x[l], y[l], s[l], keypoints.valid[l], config)
        for l in range(grad.shape[0])
    ])
    return finish_orientations(hists, keypoints.valid)
