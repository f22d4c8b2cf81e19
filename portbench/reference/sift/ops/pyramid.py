# Frozen copy of niftymatch_torch/ops/pyramid.py at commit def8df72c5c264abd9e3aa10eba50d4d66e57296, unchanged below this
# header: part of the benchmark's plain reference, imported by nothing of the program.
"""Gaussian scale-space pyramid (``ops/pyramid.py`` of the JAX package).

Per octave the ``num_gauss_levels`` Gaussian levels are one stacked tensor;
``octave[0] = blur(input, base_kernel)`` for the first octave only,
``octave[l+1] = blur(octave[l], kernels[l])``, and the next octave starts
from ``downsample_by_2(octave[num_dog_levels])``.  Every function takes
optional leading batch axes: a batch of B images is one ``(B, H, W)``
tensor, and each stage runs once for the whole batch.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from ..config import SiftConfig
from .filters import convolve_separable, downsample_by_2, gaussian_kernel_1d
from .gradients import dog_stack, gradient_polar


class OctaveData(NamedTuple):
    gauss: torch.Tensor   # (..., num_gauss_levels, H, W)
    dog: torch.Tensor     # (..., num_dogs, H, W)
    grad: torch.Tensor    # (..., num_dog_levels, H, W, 2) polar gradients


def gaussian_kernels(config: SiftConfig):
    """``(base_kernel, [level_kernels...])`` as numpy taps."""
    base = gaussian_kernel_1d(config.base_smooth)
    levels = [gaussian_kernel_1d(s) for s in config.sigmas]
    return base, levels


def build_octave_gaussians(
    base_image: torch.Tensor, level_kernels, num_levels: int, first_kernel=None
) -> torch.Tensor:
    current = base_image
    if first_kernel is not None:
        current = convolve_separable(current, first_kernel)
    levels = [current]
    for l in range(num_levels - 1):
        current = convolve_separable(current, level_kernels[l])
        levels.append(current)
    return torch.stack(levels, dim=-3)


def gradients_for_octave(gauss: torch.Tensor, config: SiftConfig) -> torch.Tensor:
    """Gradients of Gaussian levels 1..num_dog_levels (``siftfunctions.cu:53-63``)."""
    return gradient_polar(gauss[..., 1 : 1 + config.num_dog_levels, :, :])


def build_pyramid(image: torch.Tensor, config: SiftConfig) -> List[OctaveData]:
    """Per-octave ``OctaveData`` for a float (..., H, W) image or batch."""
    if tuple(image.shape[-2:]) != (config.height, config.width):
        raise ValueError(
            f"image shape {tuple(image.shape)} != config "
            f"(..., {config.height}, {config.width})"
        )
    base_kernel, level_kernels = gaussian_kernels(config)
    octaves: List[OctaveData] = []
    current = image.to(torch.float32)
    for o in range(config.num_octaves):
        gauss = build_octave_gaussians(
            current, level_kernels, config.num_gauss_levels,
            first_kernel=base_kernel if o == 0 else None,
        )
        octaves.append(
            OctaveData(gauss=gauss, dog=dog_stack(gauss),
                       grad=gradients_for_octave(gauss, config))
        )
        current = downsample_by_2(gauss[..., config.num_dog_levels, :, :])
    return octaves
