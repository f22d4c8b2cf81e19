"""Calibrated homography decomposition and planar pose recovery
(``sfm/homography.py`` of the JAX package).

Quasi-planar scenes make the essential matrix unrecoverable, so the
two-view front end runs both models and, when the homography wins, takes
the relative pose from ``H = R + t n^T / d``: the Faugeras/Malis SVD
decomposition, branchless and batched, 4 sign candidates x {+t, -t},
resolved by the same cheirality vote as ``recover_pose``.
"""

from __future__ import annotations

import torch

from ..geometry.linalg import svd3x3
from ..utils.precision import f32
from .triangulation import PoseRecovery, _det3, _vote_cheirality


@f32
def decompose_homography(H: torch.Tensor):
    """Decompose a calibrated homography into candidate (R, t_dir, n).

    ``H`` maps normalised coords of view A to view B: x_b ~ H x_a, with
    ``H = R + t n^T / d`` (plane n.x = d in A's frame).  Returns stacked
    candidates (..., 4, 3, 3), (..., 4, 3), (..., 4, 3): four (eps1, eps3)
    sign choices; callers also try -t during cheirality."""
    U, S, Vt = svd3x3(H)
    d1, d2, d3 = S[..., 0], S[..., 1], S[..., 2]
    # Scale so the middle singular value is 1.
    d1 = d1 / torch.clamp(d2, min=1e-12)
    d3 = d3 / torch.clamp(d2, min=1e-12)
    s = _det3(U) * _det3(Vt.transpose(-1, -2))

    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    x1m = torch.sqrt(torch.clamp((d1 * d1 - 1.0) / denom, min=0.0))
    x3m = torch.sqrt(torch.clamp((1.0 - d3 * d3) / denom, min=0.0))

    Rs, ts, ns = [], [], []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            x1 = e1 * x1m
            x3 = e3 * x3m
            sin_t = (d1 - d3) * x1 * x3
            cos_t = d1 * x3 * x3 + d3 * x1 * x1
            # Normalise the (cos, sin) pair (guards d2-scaling drift).
            nrm = torch.clamp(torch.sqrt(sin_t**2 + cos_t**2), min=1e-12)
            sin_t = sin_t / nrm
            cos_t = cos_t / nrm
            zero = torch.zeros_like(cos_t)
            one = torch.ones_like(cos_t)
            Rp = torch.stack(
                [
                    torch.stack([cos_t, zero, -sin_t], -1),
                    torch.stack([zero, one, zero], -1),
                    torch.stack([sin_t, zero, cos_t], -1),
                ],
                -2,
            )
            tp = torch.stack([(d1 - d3) * x1, zero, -(d1 - d3) * x3], -1)
            np_ = torch.stack([x1, zero, x3], -1)
            Rs.append(s[..., None, None] * (U @ Rp @ Vt))
            ts.append((U @ tp[..., None])[..., 0])
            ns.append((Vt.transpose(-1, -2) @ np_[..., None])[..., 0])
    # The candidate axis goes before the matrix/vector axes (-3 / -2), so
    # the decomposition takes leading batch axes.
    return torch.stack(Rs, dim=-3), torch.stack(ts, dim=-2), torch.stack(ns, dim=-2)


@f32
def recover_pose_homography(H, pts_a, pts_b, mask) -> PoseRecovery:
    """Cheirality-voted (R, t) from a calibrated homography: the 4
    decomposition candidates and both translation signs, all eight through
    one batched ``_vote_cheirality``.  ``t`` is unit-normalised (the 1/d
    plane-depth scale is unobservable, like E's baseline)."""
    Rs, ts, _ = decompose_homography(H)
    tn = ts / torch.clamp(torch.linalg.vector_norm(ts, dim=-1, keepdim=True), min=1e-12)
    R8 = torch.cat([Rs, Rs], dim=-3)                     # (..., 8, 3, 3)
    t8 = torch.cat([tn, -tn], dim=-2)                    # (..., 8, 3)
    return _vote_cheirality(R8, t8, pts_a, pts_b, mask)
