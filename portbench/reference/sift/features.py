# Frozen copy of niftymatch_torch/features.py at commit def8df72c5c264abd9e3aa10eba50d4d66e57296, unchanged below this
# header: part of the benchmark's plain reference, imported by nothing of the program.
"""Fixed-capacity feature container, the PyTorch counterpart of
``niftymatch_tpu/features.py``.

Every field shares the capacity axis K, which is the LAST axis of the
per-feature fields (``desc`` has its 128 values after it), so the same
functions serve one image ``(K,)`` and a batch ``(B, K)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import SIFT_VECTOR_SIZE


class Features(NamedTuple):
    x: torch.Tensor          # (..., K) float32, input-image coords
    y: torch.Tensor          # (..., K) float32
    sigma: torch.Tensor      # (..., K) float32 absolute scale
    angle: torch.Tensor      # (..., K) float32 first orientation
    response: torch.Tensor   # (..., K) float32 |DoG| response
    octave: torch.Tensor     # (..., K) int32
    level: torch.Tensor      # (..., K) int32 DoG level within octave
    desc: torch.Tensor       # (..., K, 128) float32
    valid: torch.Tensor      # (..., K) bool

    @property
    def capacity(self) -> int:
        return self.x.shape[-1]

    def count(self) -> torch.Tensor:
        """Number of live features (device tensor; no host sync)."""
        return self.valid.sum(dim=-1, dtype=torch.int32)

    @staticmethod
    def empty(capacity: int, device="cpu", batch_shape=()) -> "Features":
        shape = tuple(batch_shape) + (capacity,)
        z = torch.zeros(shape, dtype=torch.float32, device=device)
        zi = torch.zeros(shape, dtype=torch.int32, device=device)
        return Features(
            x=z, y=z, sigma=z, angle=z, response=z, octave=zi, level=zi,
            desc=torch.zeros(shape + (SIFT_VECTOR_SIZE,), dtype=torch.float32,
                             device=device),
            valid=torch.zeros(shape, dtype=torch.bool, device=device),
        )

    def take(self, idx: torch.Tensor, new_valid: torch.Tensor) -> "Features":
        """Gather slots along the capacity axis with a validity override."""
        return Features(
            *[take_slots(a, idx) for a in self[:-1]], valid=new_valid
        )


def take_slots(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather along the capacity axis: ``idx`` is (..., k) like a field."""
    if a.dim() == idx.dim():
        return torch.gather(a, -1, idx)
    full = idx.unsqueeze(-1).expand(*idx.shape, a.shape[-1])
    return torch.gather(a, -2, full)


def topk_desc_stable(scores: torch.Tensor, k: int):
    """Top-k along the last axis, lower index first among equal scores.

    ``jax.lax.top_k`` orders ties by index; ``torch.topk`` makes no such
    promise on CUDA, so this is a stable descending sort cut to k.
    """
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def concat_features(parts) -> Features:
    """Concatenate feature sets along the capacity axis."""
    out = []
    for arrs in zip(*parts):
        dim = -2 if arrs[0].dim() == parts[0].x.dim() + 1 else -1
        out.append(torch.cat(arrs, dim=dim))
    return Features(*out)


def topk_features(feats: Features, k: int) -> Features:
    """Global top-k by response (``features.py:82-92`` of the JAX package)."""
    scores = torch.where(feats.valid, feats.response,
                         torch.full_like(feats.response, float("-inf")))
    kk = min(k, scores.shape[-1])
    top_scores, idx = topk_desc_stable(scores, kk)
    out = feats.take(idx, torch.isfinite(top_scores))
    if kk < k:
        pad = Features.empty(k - kk, scores.device, scores.shape[:-1])
        out = concat_features([out, pad])
    return out
