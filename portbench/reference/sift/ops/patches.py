# Frozen copy of niftymatch_torch/ops/patches.py at commit def8df72c5c264abd9e3aa10eba50d4d66e57296, unchanged below this
# header: part of the benchmark's plain reference, imported by nothing of the program.
"""Fixed-size window gathers around keypoints (``ops/patches.py`` of the
JAX package).

Out-of-image samples read zero-padding, which carries zero gradient
magnitude and so adds nothing to any histogram.  Out-of-range centre
indices are clamped, as ``jax.lax.dynamic_slice`` clamps them.
"""

from __future__ import annotations

import torch


def gather_windows(planes: torch.Tensor, slab: torch.Tensor,
                   row0: torch.Tensor, col0: torch.Tensor, size: int):
    """``planes[slab, row0:row0+size, col0:col0+size]`` for each keypoint.

    ``planes``: (S, H, W[, C]); ``slab``/``row0``/``col0``: (K,) integer.
    Returns (K, size, size[, C]).
    """
    ar = torch.arange(size, device=planes.device)
    rows = (row0.long()[:, None] + ar)[:, :, None]
    cols = (col0.long()[:, None] + ar)[:, None, :]
    return planes[slab.long()[:, None, None], rows, cols]


def gather_patches(img: torch.Tensor, yc: torch.Tensor, xc: torch.Tensor,
                   radius: int):
    """(2 radius + 1)^2 patches of an (H, W[, C]) image centred at integer
    coordinates (yc, xc), clamped into the image: (K, P, P[, C])."""
    h, w = img.shape[0], img.shape[1]
    yc = torch.clamp(yc, 0, h - 1)
    xc = torch.clamp(xc, 0, w - 1)
    pad = [0, 0] * (img.dim() - 2) + [radius, radius, radius, radius]
    padded = torch.nn.functional.pad(img, pad)[None]
    return gather_windows(padded, torch.zeros_like(yc), yc, xc, 2 * radius + 1)


def patch_offsets(radius: int, device="cpu"):
    """(P, P) float offset grids (dy, dx) in [-radius, radius]."""
    r = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    p = 2 * radius + 1
    return r[:, None].expand(p, p), r[None, :].expand(p, p)
