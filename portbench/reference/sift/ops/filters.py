# Frozen copy of niftymatch_torch/ops/filters.py at commit def8df72c5c264abd9e3aa10eba50d4d66e57296, unchanged below this
# header: part of the benchmark's plain reference, imported by nothing of the program.
"""Separable Gaussian filtering and decimation (``ops/filters.py`` of the
JAX package).

* Taps: radius ``ceil(4 sigma)``, ``exp(-0.5 ((j - r)/sigma)^2)`` normalised
  to unit sum (``pyramidata.cu:105-123``), computed on the host in numpy
  exactly as the JAX package does.
* Blur: zero-padded shift-and-add in the same tap order as the JAX
  ``_conv_1d``, in exact fp32.  Each tap is one fused multiply-add
  (``torch.add`` with ``alpha``), as XLA fuses ``acc + tap * x``, so the
  CPU result is the JAX one up to a rare last-bit difference.  No cuDNN
  convolution, so TF32 never enters.
* Decimation: every other pixel, no prefilter (``downsample.cu:14-16``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel_1d(sigma: float) -> np.ndarray:
    """Float32 taps of length ``2 * ceil(4 sigma) + 1`` summing to 1."""
    radius = int(math.ceil(sigma * 4.0))
    xs = (np.arange(2 * radius + 1, dtype=np.float32) - radius) / np.float32(sigma)
    k = np.exp(-0.5 * xs * xs).astype(np.float32)
    return k / k.sum(dtype=np.float32)


def _conv_1d(x: torch.Tensor, kernel, dim: int) -> torch.Tensor:
    """Zero-padded 1-D correlation along ``dim`` (-1 or -2) of (..., H, W).

    ``out[j] = sum_i taps[i] * x[j + i - radius]``, summed in tap order.
    """
    taps = np.asarray(kernel, np.float32)
    radius = taps.shape[0] // 2
    n = x.shape[dim]
    pad = (radius, radius) if dim == -1 else (0, 0, radius, radius)
    xp = F.pad(x.to(torch.float32), pad)
    acc = float(taps[0]) * xp.narrow(dim, 0, n)
    for i in range(1, taps.shape[0]):
        acc = torch.add(acc, xp.narrow(dim, i, n), alpha=float(taps[i]))
    return acc


def convolve_separable(image: torch.Tensor, kernel) -> torch.Tensor:
    """Row pass then column pass (``convolution.cu:140-159``) on (..., H, W)."""
    out = _conv_1d(image, kernel, dim=-1)
    return _conv_1d(out, kernel, dim=-2)


def downsample_by_2(image: torch.Tensor) -> torch.Tensor:
    """``result[y, x] = source[2y, 2x]``; output dims ``floor(d / 2)``."""
    h, w = image.shape[-2], image.shape[-1]
    return image[..., 0 : (h // 2) * 2 : 2, 0 : (w // 2) * 2 : 2]
