"""Batched two-view triangulation and essential-matrix pose recovery
(``sfm/triangulation.py`` of the JAX package).

Conventions: camera poses are world->camera Rt (3, 4) as in ``se3.py``;
image points are normalised camera coordinates (x, y) = (X/Z, Y/Z).  Every
function takes leading batch axes and masks instead of compacting.

The eigen-solvers are the port's own (``geometry/linalg.py``), with the JAX
file's conventions: the DLT null vector is ``smallest_eigvec`` (inverse
iteration, unit norm, sign from its fixed start vector) and the essential
decomposition uses ``svd3x3``, whose U is rebuilt orthonormal for a rank-2
E.  ``torch.linalg.svd``/``eigh`` would pick other signs and rotations, and
the four-candidate vote would then compare other candidates.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.linalg import smallest_eigvec, svd3x3
from ..utils.precision import f32
from .se3 import se3_apply


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by cofactors (one fused expression per
    batch, no solver call)."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


@f32
def triangulate_midpoint(T_a, T_b, pts_a, pts_b) -> torch.Tensor:
    """Midpoint triangulation of (N, 2) normalised correspondences.

    Fast closed form; good conditioning for well-separated rays."""
    Ra, ta = T_a[..., :3], T_a[..., 3]
    Rb, tb = T_b[..., :3], T_b[..., 3]
    Ca = -(Ra.transpose(-1, -2) @ ta[..., None])[..., 0]
    Cb = -(Rb.transpose(-1, -2) @ tb[..., None])[..., 0]
    da = torch.cat([pts_a, torch.ones_like(pts_a[..., :1])], dim=-1)
    db = torch.cat([pts_b, torch.ones_like(pts_b[..., :1])], dim=-1)
    da = da @ Ra  # R^T d : camera ray to world
    db = db @ Rb
    da = da / torch.linalg.vector_norm(da, dim=-1, keepdim=True)
    db = db / torch.linalg.vector_norm(db, dim=-1, keepdim=True)
    # Solve for s, t minimising ||Ca + s da - Cb - t db||.
    w = Ca - Cb
    a = (da * da).sum(-1)
    b = (da * db).sum(-1)
    c = (db * db).sum(-1)
    d = (da * w).sum(-1)
    e = (db * w).sum(-1)
    denom = a * c - b * b
    denom = torch.where(torch.abs(denom) > 1e-12, denom, 1e-12)
    s = (b * e - c * d) / denom
    t = (a * e - b * d) / denom
    return 0.5 * (Ca + s[..., None] * da + Cb + t[..., None] * db)


@f32
def triangulate_dlt(T_a, T_b, pts_a, pts_b) -> torch.Tensor:
    """Linear (DLT) triangulation: smallest eigenvector of the 4x4 normal
    matrix per correspondence."""
    rows = []
    for P, pts in ((T_a, pts_a), (T_b, pts_b)):  # (3, 4), identity intrinsics
        x, y = pts[..., 0], pts[..., 1]
        rows.append(x[..., None] * P[..., 2, :] - P[..., 0, :])
        rows.append(y[..., None] * P[..., 2, :] - P[..., 1, :])
    A = torch.stack(rows, dim=-2)  # (N, 4, 4)
    M = A.transpose(-1, -2) @ A
    X = smallest_eigvec(M)
    w = X[..., 3]
    w = torch.where(torch.abs(w) > 1e-12, w, 1e-12)
    return X[..., :3] / w[..., None]


@f32
def reprojection_error(T, pts3, obs) -> torch.Tensor:
    """Squared reprojection error (normalised coords) of (N, 3) points
    against (N, 2) observations under pose T."""
    pc = se3_apply(T, pts3)
    z = torch.where(torch.abs(pc[..., 2]) > 1e-9, pc[..., 2], 1e-9)
    proj = pc[..., :2] / z[..., None]
    d = proj - obs
    return (d * d).sum(-1)


@f32
def depths(T, pts3) -> torch.Tensor:
    """Z-depth of world points in camera T."""
    return se3_apply(T, pts3)[..., 2]


class PoseRecovery(NamedTuple):
    R: torch.Tensor           # (3, 3) rotation of the winning hypothesis
    t: torch.Tensor           # (3,) unit translation
    points: torch.Tensor      # (N, 3) triangulated points (winning hypothesis)
    cheirality: torch.Tensor  # (N,) bool both-camera positive depth
    num_good: torch.Tensor    # () int32


@f32
def decompose_essential(E: torch.Tensor):
    """E -> two rotations + unit translation (four (R, t) hypotheses),
    by the standard U W V^T construction with det corrections."""
    U, S, Vt = svd3x3(E)
    # Enforce proper rotations.
    dU = _det3(U)
    dV = _det3(Vt.transpose(-1, -2))
    one = torch.ones_like(dU)
    U = U * torch.stack([one, one, dU], -1)[..., None, :]
    Vt = Vt * torch.stack([one, one, dV], -1)[..., :, None]
    e = torch.eye(3, dtype=E.dtype, device=E.device)
    W = torch.stack([-e[1], e[0], e[2]])     # [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    t = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)
    return R1, R2, t


@f32
def recover_pose(E, pts_a, pts_b, mask) -> PoseRecovery:
    """Cheirality-voted (R, t) from an essential matrix and inlier
    correspondences (normalised coords).  Convention: x_b ~ R x_a + t
    (camera A is the world frame)."""
    R1, R2, t = decompose_essential(E)
    # All four hypotheses ride one candidate axis through ONE triangulation.
    Rs = torch.stack([R1, R1, R2, R2], dim=-3)           # (..., 4, 3, 3)
    ts = torch.stack([t, -t, t, -t], dim=-2)             # (..., 4, 3)
    return _vote_cheirality(Rs, ts, pts_a, pts_b, mask)


@f32
def _vote_cheirality(Rs, ts, pts_a, pts_b, mask) -> PoseRecovery:
    """Triangulate every candidate (R, t) ((..., K, 3, 3), (..., K, 3)) of
    the (..., N, 2) correspondences in one batched DLT and pick the one
    maximising both-camera positive depths under the (..., N) mask; the
    first candidate wins a tie, as ``jnp.argmax`` picks it.  Shared by
    essential and homography pose recovery."""
    n = pts_a.shape[-2]
    eye34 = torch.cat([torch.eye(3, dtype=Rs.dtype, device=Rs.device),
                       torch.zeros((3, 1), dtype=Rs.dtype, device=Rs.device)], -1)
    T_b = torch.cat([Rs, ts[..., None]], dim=-1)          # (..., K, 3, 4)
    T_b_e = T_b[..., :, None, :, :]                       # (..., K, 1, 3, 4)
    pa = pts_a[..., None, :, :].expand(*Rs.shape[:-2], n, 2)
    pb = pts_b[..., None, :, :].expand(*Rs.shape[:-2], n, 2)
    pts = triangulate_dlt(eye34, T_b_e, pa, pb)           # (..., K, N, 3)
    good = (depths(eye34, pts) > 0) & (depths(T_b, pts) > 0) & mask[..., None, :]
    counts = good.sum(-1, dtype=torch.int32)              # (..., K)
    best = torch.argmax(counts, dim=-1)
    # One-hot selection over the small candidate axis.
    oh = torch.arange(counts.shape[-1], device=counts.device) == best[..., None]
    ohf = oh.to(Rs.dtype)
    R = (ohf[..., None, None] * Rs).sum(-3)
    tt = (ohf[..., None] * ts).sum(-2)
    pts_w = (ohf[..., None, None] * pts).sum(-3)
    # any(), not sum(): cheirality stays a bool mask.
    good_w = (good & oh[..., None]).any(-2)
    num = torch.where(oh, counts, 0).sum(-1, dtype=torch.int32)
    return PoseRecovery(R=R, t=tt, points=pts_w, cheirality=good_w, num_good=num)
