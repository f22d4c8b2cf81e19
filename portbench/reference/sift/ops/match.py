# Frozen copy of niftymatch_torch/ops/match.py at commit def8df72c5c264abd9e3aa10eba50d4d66e57296, unchanged below this
# header: part of the benchmark's plain reference, imported by nothing of the program.
"""Brute-force descriptor matching: distance GEMM + Lowe ratio test
(``ops/match.py`` of the JAX package; ``match.cu:13-117`` of the reference).

``||a - b||^2 = ||a||^2 + ||b||^2 - 2 a.b``; a match is ``argmin`` iff
``min1/min2 < ambiguity`` and ``min2 > 0``; -1 marks no match.  Invalid
slots are excluded by +inf distances.  Every function takes optional
leading batch axes (one per pair).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class MatchResult(NamedTuple):
    indices: torch.Tensor    # (..., A) int32 index into B, -1 if unmatched
    distances: torch.Tensor  # (..., A) squared L2 distance of the best match
    ratios: torch.Tensor     # (..., A) min1/min2 (1.0 where undefined)


def pairwise_sq_distances(a: torch.Tensor, b: torch.Tensor,
                          precision: str = "fp32") -> torch.Tensor:
    """All-pairs squared L2 distances, (..., A, D) x (..., B, D) -> (..., A, B).

    ``precision='bf16'`` rounds the GEMM operands to bfloat16 (norms stay
    fp32); the products and their sum are fp32 either way."""
    a32 = a.to(torch.float32)
    b32 = b.to(torch.float32)
    a_norm = (a32 * a32).sum(dim=-1)
    b_norm = (b32 * b32).sum(dim=-1)
    if precision == "bf16":
        a32 = a32.to(torch.bfloat16).to(torch.float32)
        b32 = b32.to(torch.bfloat16).to(torch.float32)
    ab = torch.matmul(a32, b32.transpose(-1, -2))
    d = a_norm[..., :, None] + b_norm[..., None, :] - 2.0 * ab
    return torch.clamp(d, min=0.0)


def top2_min(d: torch.Tensor):
    """Row-wise (min1, argmin1, min2); ties go to the lowest column, and
    min2 is the smallest distance at any OTHER column."""
    min1, idx1 = torch.min(d, dim=-1)
    cols = torch.arange(d.shape[-1], device=d.device)
    masked = torch.where(cols == idx1[..., None],
                         torch.full_like(d, float("inf")), d)
    min2 = masked.min(dim=-1).values
    return min1, idx1.to(torch.int32), min2


def ratio_test_matches(dist: torch.Tensor, ambiguity: float = 0.8,
                       a_valid: torch.Tensor | None = None,
                       b_valid: torch.Tensor | None = None) -> MatchResult:
    if b_valid is not None:
        dist = torch.where(b_valid[..., None, :], dist,
                           torch.full_like(dist, float("inf")))
    min1, idx1, min2 = top2_min(dist)
    return _ratio_test(min1, idx1, min2, torch.isfinite(min1), ambiguity, a_valid)


def _ratio_test(min1, idx1, min2, had_valid, ambiguity, a_valid) -> MatchResult:
    """Lowe acceptance shared by the oracle and the fused-kernel path."""
    pos = min2 > 0.0
    ratio = min1 / torch.where(pos, min2, torch.ones_like(min2))
    ok = pos & (ratio < ambiguity) & had_valid
    if a_valid is not None:
        ok = ok & a_valid
    return MatchResult(
        indices=torch.where(ok, idx1, torch.full_like(idx1, -1)),
        distances=torch.where(had_valid, min1, torch.zeros_like(min1)),
        ratios=torch.where(pos, ratio, torch.ones_like(ratio)),
    )


def match_descriptors(desc_a: torch.Tensor, desc_b: torch.Tensor,
                      ambiguity: float = 0.8,
                      a_valid: torch.Tensor | None = None,
                      b_valid: torch.Tensor | None = None,
                      precision: str = "fp32") -> MatchResult:
    """Distance GEMM + ratio test (``siftfunctions.cu:15-40``)."""
    d = pairwise_sq_distances(desc_a, desc_b, precision=precision)
    return ratio_test_matches(d, ambiguity, a_valid, b_valid)


def mutual_matches(fwd: MatchResult, bwd: MatchResult) -> torch.Tensor:
    """Cross-check: A->B matches whose B->A match points back, else -1
    (int32 (..., A))."""
    a_idx = torch.arange(fwd.indices.shape[-1], dtype=torch.int32,
                         device=fwd.indices.device)
    hit = fwd.indices >= 0
    back = torch.gather(bwd.indices, -1, torch.clamp(fwd.indices, min=0).long())
    back = torch.where(hit, back, torch.full_like(back, -2))
    return torch.where(back == a_idx, fwd.indices, torch.full_like(fwd.indices, -1))


def mutual_ratio_match(desc_a: torch.Tensor, valid_a: torch.Tensor,
                       desc_b: torch.Tensor, valid_b: torch.Tensor,
                       ambiguity: float = 0.8) -> torch.Tensor:
    """Cross-checked Lowe ratio matches of each pair: one distance GEMM,
    the forward and backward ratio tests, then ``mutual_matches``."""
    dm = pairwise_sq_distances(desc_a, desc_b)
    fwd = ratio_test_matches(dm, ambiguity, valid_a, valid_b)
    bwd = ratio_test_matches(dm.transpose(-1, -2), ambiguity, valid_b, valid_a)
    return mutual_matches(fwd, bwd)
