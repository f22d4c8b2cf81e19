"""Pixel-format ops (``ops/image.py`` of the JAX package;
``bgra_2_gray.cu`` and ``cast.cu`` of the reference): grayscale
conversion, channel access and a saturating cast.  Each returns a new
tensor and leaves its input as it was."""

from __future__ import annotations

import torch

# B, G, R weights of bgra_2_gray.cu:16
_GRAY_WEIGHTS = (0.07, 0.72, 0.21)


def bgra_to_gray(bgra: torch.Tensor) -> torch.Tensor:
    """(..., 4) BGRA -> float32 (...) ``0.07 B + 0.72 G + 0.21 R``, in the
    input's value range."""
    b, g, r = (bgra[..., i].to(torch.float32) for i in range(3))
    return _GRAY_WEIGHTS[0] * b + _GRAY_WEIGHTS[1] * g + _GRAY_WEIGHTS[2] * r


def extract_channel(bgra: torch.Tensor, channel: int) -> torch.Tensor:
    """One channel as float32 (``bgra_2_gray.cu:35-48``)."""
    return bgra[..., channel].to(torch.float32)


def put_channel(bgra: torch.Tensor, values: torch.Tensor, channel: int) -> torch.Tensor:
    """``bgra`` with ``values`` in ``channel``; writing channel 3 (alpha)
    sets it to 255 whatever ``values`` holds (``bgra_2_gray.cu:66-82``)."""
    out = bgra.clone()
    if channel == 3:
        out[..., 3] = 255
    else:
        out[..., channel] = values.to(bgra.dtype)
    return out


def set_alpha(bgra: torch.Tensor, value: int) -> torch.Tensor:
    """``bgra`` with a constant alpha (``bgra_2_gray.cu:95-112``)."""
    out = bgra.clone()
    out[..., 3] = value
    return out


def cast_saturate(src: torch.Tensor, dtype: torch.dtype, max_val=0) -> torch.Tensor:
    """Cast to ``dtype``; unless ``max_val`` is 0, values >= max_val become
    max_val first (``cast.cu:7-21``)."""
    if max_val != 0:
        src = torch.where(src >= max_val, torch.full_like(src, max_val), src)
    return src.to(dtype)


def transpose_2d(image: torch.Tensor) -> torch.Tensor:
    """Swap the last two axes (``transpose.cu:8-30``)."""
    return image.transpose(-1, -2)


def subtract_images(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a - b`` (``cudamath.cu:26-35``), the DoG primitive."""
    return a - b
