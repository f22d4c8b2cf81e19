# Frozen copy of niftymatch_torch/ops/gradients.py at commit def8df72c5c264abd9e3aa10eba50d4d66e57296, unchanged below this
# header: part of the benchmark's plain reference, imported by nothing of the program.
"""Difference-of-Gaussians and polar gradients (``ops/gradients.py`` of
the JAX package; ``cudamath.cu:26-54`` of the reference)."""

from __future__ import annotations

import torch

TWO_PI = 6.283185307179586


def div_const(a: torch.Tensor, c: float) -> torch.Tensor:
    """IEEE ``a / c`` on every device.  PyTorch's CUDA division by a Python
    number multiplies by its rounded reciprocal, which moves a quotient
    by an ulp now and then; where the quotient is floored into a bin, that
    ulp moves a pixel to the next bin.  A 0-dim tensor on the same device
    divides exactly, as the JAX package and the CUDA kernels do."""
    return a / torch.full((), c, dtype=a.dtype, device=a.device)


def dog_stack(gauss_levels: torch.Tensor) -> torch.Tensor:
    """``(..., L, H, W) -> (..., L-1, H, W)``, ``dog[i] = g[i+1] - g[i]``."""
    return gauss_levels[..., 1:, :, :] - gauss_levels[..., :-1, :, :]


def mod_2pi(x: torch.Tensor) -> torch.Tensor:
    """Wrap into [0, 2pi).  ``torch.remainder`` takes the sign of the
    divisor, as ``jnp.mod`` does (``cudamath.h:82-87``)."""
    return torch.remainder(torch.remainder(x, TWO_PI) + TWO_PI, TWO_PI)


def gradient_polar(image: torch.Tensor) -> torch.Tensor:
    """``(..., H, W) -> (..., H, W, 2)`` with channels (magnitude, angle).

    magnitude ``0.5 * sqrt(dx^2 + dy^2)``; angle ``atan2(dy, dx) + 2pi``
    wrapped into [0, 2pi), 0 where the magnitude is 0; the outermost ring
    of pixels is (0, 0).
    """
    dx = torch.zeros_like(image)
    dy = torch.zeros_like(image)
    dx[..., 1:-1, 1:-1] = image[..., 1:-1, 2:] - image[..., 1:-1, :-2]
    dy[..., 1:-1, 1:-1] = image[..., 2:, 1:-1] - image[..., :-2, 1:-1]
    mag = 0.5 * torch.sqrt(dx * dx + dy * dy)
    ang = torch.where(
        mag == 0.0, torch.zeros_like(mag), mod_2pi(torch.atan2(dy, dx) + TWO_PI)
    )
    return torch.stack([mag, ang], dim=-1)
