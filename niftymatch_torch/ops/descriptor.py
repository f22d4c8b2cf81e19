"""128-D SIFT descriptors as separable tent weights (``ops/descriptor.py``
of the JAX package; ``descriptor.cu:32-145`` of the reference).

* ``SBP = 3 s + eps``; square window ``|off| <= floor(sqrt(2) SBP 5/2 + 0.5)``;
* coordinates rotated by the keypoint's angle and scaled to spatial-bin
  units: ``nx = (c dx + s dy)/SBP``, ``ny = (-s dx + c dy)/SBP``;
* Gaussian window ``exp(-(nx^2 + ny^2)/8)`` (sign flipped under
  ``compat.flipped_gaussian_sign``);
* trilinear soft-binning written as per-axis tents, 4x4 spatial bins
  centred at ``b - 1.5`` and 8 circular theta bins, layout
  ``ybin*32 + xbin*8 + tbin``;
* the standard normalise -> clamp 0.2 -> renormalise unless
  ``compat.unnormalized_descriptors``.

``_descriptor_core`` is also the plain version of kernel K3
(``kernels/windows.py``); ``compute_descriptors`` is the per-octave oracle
path (``sift.detect_and_describe_per_octave``).
"""

from __future__ import annotations

import math

import torch

from ..config import (
    DESC_MAGNIF,
    MACHINE_EPS,
    NUM_DESC_ORI_BINS,
    NUM_DESC_SPATIAL_BINS,
    SIFT_VECTOR_SIZE,
    SiftConfig,
)
from .gradients import TWO_PI, div_const, mod_2pi
from .patches import gather_patches, patch_offsets

NBO = NUM_DESC_ORI_BINS
NBP = NUM_DESC_SPATIAL_BINS


def descriptor_radius_for_sigma(sigma: float) -> int:
    sbp = DESC_MAGNIF * sigma + MACHINE_EPS
    return int(math.floor(math.sqrt(2.0) * sbp * (NBP + 1) / 2.0 + 0.5))


def static_radius_for_level(level: int, config: SiftConfig) -> int:
    """Window radius bound for a level: ``sigma <= sigma_0 2^((l+1)/L)``."""
    s_max = config.sigma_0 * 2.0 ** ((level + 1.0) / config.num_dog_levels)
    return descriptor_radius_for_sigma(s_max)


def _spatial_tents(n: torch.Tensor) -> torch.Tensor:
    """(..., P2) -> (..., P2, NBP): ``relu(1 - |n - (b - NBP/2 + 0.5)|)``."""
    centers = torch.arange(NBP, dtype=torch.float32, device=n.device) - (NBP / 2 - 0.5)
    return torch.clamp(1.0 - torch.abs(n[..., None] - centers), min=0.0)


def _theta_tents(nt: torch.Tensor) -> torch.Tensor:
    """Circular tents over the NBO orientation bins (wrap mod NBO)."""
    centers = torch.arange(NBO, dtype=torch.float32, device=nt.device)
    d = nt[..., None] - centers
    d = d - NBO * torch.round(div_const(d, float(NBO)))
    return torch.clamp(1.0 - torch.abs(d), min=0.0)


def _descriptor_core(mag, ang, x, y, xi, yi, s, angle0, valid, radius: int,
                     config: SiftConfig) -> torch.Tensor:
    """Raw (K, 128) descriptors from (K, P, P) gradient patches."""
    k = x.shape[0]
    mag = mag.reshape(k, -1)
    ang = ang.reshape(k, -1)

    sbp = DESC_MAGNIF * s + MACHINE_EPS
    w_r = torch.floor(math.sqrt(2.0) * sbp * (NBP + 1) / 2.0 + 0.5)

    off_y, off_x = patch_offsets(radius, mag.device)
    off_x = off_x.reshape(-1)
    off_y = off_y.reshape(-1)

    dx = off_x[None] + (xi.to(torch.float32) - x)[:, None]
    dy = off_y[None] + (yi.to(torch.float32) - y)[:, None]

    st = torch.sin(angle0)[:, None]
    ct = torch.cos(angle0)[:, None]
    nx = (ct * dx + st * dy) / sbp[:, None]
    ny = (-st * dx + ct * dy) / sbp[:, None]

    theta = mod_2pi(ang - angle0[:, None])
    nt = div_const(NBO * theta, TWO_PI)

    sign = 1.0 if config.compat.flipped_gaussian_sign else -1.0
    wsigma = NBP / 2.0
    win = torch.exp(sign * (nx * nx + ny * ny) / (2.0 * wsigma * wsigma))

    inside = (
        (torch.abs(off_x)[None] <= w_r[:, None])
        & (torch.abs(off_y)[None] <= w_r[:, None])
        & valid[:, None]
    )
    w = torch.where(inside, win * mag, torch.zeros_like(mag))

    wx = _spatial_tents(nx)
    wy = _spatial_tents(ny)
    wt = _theta_tents(nt)

    wxy = (wy[:, :, :, None] * wx[:, :, None, :]).reshape(k, -1, NBP * NBP)
    lhs = (w[:, :, None] * wxy).transpose(1, 2)
    hist = torch.bmm(lhs, wt)                                  # (K, 16, 8)
    return hist.reshape(k, SIFT_VECTOR_SIZE)


def normalize_descriptors(desc: torch.Tensor) -> torch.Tensor:
    """Unit norm -> clamp 0.2 -> renormalise."""
    eps = MACHINE_EPS
    desc = desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + eps)
    desc = torch.clamp(desc, max=0.2)
    return desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + eps)


def finish_descriptors(desc: torch.Tensor, valid: torch.Tensor,
                       config: SiftConfig) -> torch.Tensor:
    """Normalisation (unless the compat flag says otherwise) and zeros on
    invalid slots."""
    if not config.compat.unnormalized_descriptors:
        desc = normalize_descriptors(desc)
    return torch.where(valid[..., None], desc, torch.zeros_like(desc))


def compute_descriptors(keypoints, angles: torch.Tensor,
                        angles_valid: torch.Tensor, grad: torch.Tensor,
                        octave: int, config: SiftConfig, angle_index: int = 0):
    """Descriptors of one octave's (L, K) keypoints at orientation peak
    ``angle_index`` from its (L, H, W, 2) gradients
    (``siftfunctions.cu:154-181``): (L, K, 128) and validity (L, K).  Each
    level gathers windows of its own static radius around the clamped
    centre and takes the sub-pixel offsets from the unclamped one, as the
    JAX per-octave path does."""
    xper = float(2.0 ** octave)
    x, y, s = keypoints.x / xper, keypoints.y / xper, keypoints.sigma / xper
    descs, dvalids = [], []
    for lvl in range(grad.shape[0]):
        radius = static_radius_for_level(lvl, config)
        valid = keypoints.valid[lvl] & angles_valid[lvl, :, angle_index]
        xi = torch.floor(x[lvl] + 0.5).to(torch.int32)
        yi = torch.floor(y[lvl] + 0.5).to(torch.int32)
        patches = gather_patches(grad[lvl], yi, xi, radius)
        descs.append(_descriptor_core(
            patches[..., 0], patches[..., 1], x[lvl], y[lvl], xi, yi, s[lvl],
            angles[lvl, :, angle_index], valid, radius, config))
        dvalids.append(valid)
    dvalid = torch.stack(dvalids)
    return finish_descriptors(torch.stack(descs), dvalid, config), dvalid
