"""2-D and two-view transform estimators (``geometry/transforms.py`` of the
JAX package; ``ransac.cu:61-434`` of the reference).

Every solver is mask-weighted and batch-polymorphic: points of weight 0 do
not influence the fit, so one call serves a batch of minimal samples
(one-hot weight rows, a leading hypothesis axis) and a least-squares refit
on an inlier set.  The DLT normal matrix ``sum_i w_i r_i r_i^T`` is formed
as one batched product ``(w r)^T r``, so no (..., N, 9, 9) temporary is
stored; XLA fuses that sum, eager PyTorch would not.
"""

from __future__ import annotations

import math

import torch

from ..utils.precision import f32
from .linalg import _solve3x3_cols, smallest_eigvec, svd3x3

_SQRT2 = math.sqrt(2.0)


def _rows3(*rows):
    """A (..., 3, 3) matrix from three lists of three (...) tensors."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


@f32
def apply_homography(H: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 3, 3) transforms to (..., N, 2) points; a near-zero
    projective denominator is kept at +-1e-12 (``ransac.cu:61-72``)."""
    x, y = pts[..., 0], pts[..., 1]
    xp = H[..., 0, 0, None] * x + H[..., 0, 1, None] * y + H[..., 0, 2, None]
    yp = H[..., 1, 0, None] * x + H[..., 1, 1, None] * y + H[..., 1, 2, None]
    w = H[..., 2, 0, None] * x + H[..., 2, 1, None] * y + H[..., 2, 2, None]
    tiny = torch.where(w < 0, torch.full_like(w, -1e-12), torch.full_like(w, 1e-12))
    w = torch.where(torch.abs(w) > 1e-12, w, tiny)
    return torch.stack([xp / w, yp / w], dim=-1)


@f32
def transfer_sq_error(H: torch.Tensor, src: torch.Tensor,
                      dst: torch.Tensor) -> torch.Tensor:
    """``||H(src) - dst||^2`` per point (``ransac.cu:74-77``)."""
    d = apply_homography(H, src) - dst
    return (d * d).sum(-1)


def _weighted_mean(pts: torch.Tensor, w: torch.Tensor):
    wsum = torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
    return (pts * w[..., None]).sum(-2) / wsum, wsum[..., 0]


@f32
def hartley_normalization(pts: torch.Tensor, w: torch.Tensor):
    """The similarity T taking weighted points to centroid 0 and mean norm
    sqrt(2) (``ransac.cu:105-131``): ``(normalised points, T (..., 3, 3))``."""
    mean, wsum = _weighted_mean(pts, w)
    centered = pts - mean[..., None, :]
    mean_dist = (torch.linalg.vector_norm(centered, dim=-1) * w).sum(-1) / wsum
    scale = torch.full_like(mean_dist, _SQRT2) / torch.clamp(mean_dist, min=1e-12)
    z, one = torch.zeros_like(scale), torch.ones_like(scale)
    T = _rows3([scale, z, -scale * mean[..., 0]],
               [z, scale, -scale * mean[..., 1]],
               [z, z, one])
    return centered * scale[..., None, None], T


@f32
def fit_translation(src, dst, weights) -> torch.Tensor:
    """Weighted-mean translation (``ransac.cu:314-320``)."""
    t = _weighted_mean(dst, weights)[0] - _weighted_mean(src, weights)[0]
    z, one = torch.zeros_like(t[..., 0]), torch.ones_like(t[..., 0])
    return _rows3([one, z, t[..., 0]], [z, one, t[..., 1]], [z, z, one])


@f32
def fit_similarity(src, dst, weights) -> torch.Tensor:
    """Weighted least-squares similarity ``[a -b tx; b a ty; 0 0 1]`` in
    closed form (``ransac.cu:322-434`` solve the same problem)."""
    ms, _ = _weighted_mean(src, weights)
    md, _ = _weighted_mean(dst, weights)
    cs = src - ms[..., None, :]
    cd = dst - md[..., None, :]
    w = weights
    sxx = (w * (cs[..., 0] * cs[..., 0] + cs[..., 1] * cs[..., 1])).sum(-1)
    a_num = (w * (cs[..., 0] * cd[..., 0] + cs[..., 1] * cd[..., 1])).sum(-1)
    b_num = (w * (cs[..., 0] * cd[..., 1] - cs[..., 1] * cd[..., 0])).sum(-1)
    denom = torch.clamp(sxx, min=1e-12)
    a, b = a_num / denom, b_num / denom
    tx = md[..., 0] - (a * ms[..., 0] - b * ms[..., 1])
    ty = md[..., 1] - (b * ms[..., 0] + a * ms[..., 1])
    z, one = torch.zeros_like(a), torch.ones_like(a)
    return _rows3([a, -b, tx], [b, a, ty], [z, z, one])


def _normal_matrix(r: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``sum_i w_i r_i r_i^T`` over the row axis of (..., R, 9) rows."""
    return (r * w[..., None]).transpose(-1, -2) @ r


@f32
def fit_homography(src, dst, weights) -> torch.Tensor:
    """Weighted Hartley-normalised DLT homography (``ransac.cu:84-215``),
    scaled so H[2, 2] = 1: the smallest eigenvector of the 9x9 normal
    matrix of the two DLT rows per correspondence."""
    ns, Ts = hartley_normalization(src, weights)
    nd, Td = hartley_normalization(dst, weights)
    x, y = ns[..., 0], ns[..., 1]
    u, v = nd[..., 0], nd[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], dim=-1)
    r2 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], dim=-1)
    M = _normal_matrix(torch.cat([r1, r2], dim=-2), torch.cat([weights, weights], dim=-1))
    Hn = smallest_eigvec(M).reshape(M.shape[:-2] + (3, 3))
    H = _solve3x3_cols(Td, Hn @ Ts)             # Td^-1 Hn Ts
    scale = H[..., 2, 2]
    safe = torch.where(torch.abs(scale) > 1e-12, scale, torch.ones_like(scale))
    return H / safe[..., None, None]


def _unit_frobenius(F: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.vector_norm(F.reshape(F.shape[:-2] + (9,)), dim=-1)
    return F / torch.clamp(norm, min=1e-20)[..., None, None]


@f32
def fit_fundamental(src, dst, weights) -> torch.Tensor:
    """Weighted normalised 8-point fundamental matrix, ``dst_h^T F src_h
    = 0``, projected to rank 2 and scaled to unit Frobenius norm."""
    ns, Ts = hartley_normalization(src, weights)
    nd, Td = hartley_normalization(dst, weights)
    x, y = ns[..., 0], ns[..., 1]
    u, v = nd[..., 0], nd[..., 1]
    r = torch.stack([u * x, u * y, u, v * x, v * y, v, x, y, torch.ones_like(x)], dim=-1)
    M = _normal_matrix(r, weights)
    Fn = smallest_eigvec(M).reshape(M.shape[:-2] + (3, 3))
    U, S, Vt = svd3x3(Fn)
    S2 = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    Fn = (U * S2[..., None, :]) @ Vt
    return _unit_frobenius(Td.transpose(-1, -2) @ Fn @ Ts)


@f32
def fit_essential(src, dst, weights) -> torch.Tensor:
    """Weighted 8-point essential matrix on normalised camera coordinates,
    projected onto singular values (1, 1, 0)."""
    U, S, Vt = svd3x3(fit_fundamental(src, dst, weights))
    s = 0.5 * (S[..., 0] + S[..., 1])
    S2 = torch.stack([s, s, torch.zeros_like(s)], dim=-1)
    return _unit_frobenius((U * S2[..., None, :]) @ Vt)


@f32
def sampson_sq_error(F: torch.Tensor, src: torch.Tensor,
                     dst: torch.Tensor) -> torch.Tensor:
    """First-order (Sampson) squared epipolar error per point."""
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    l0 = F[..., 0, 0, None] * x + F[..., 0, 1, None] * y + F[..., 0, 2, None]
    l1 = F[..., 1, 0, None] * x + F[..., 1, 1, None] * y + F[..., 1, 2, None]
    l2 = F[..., 2, 0, None] * x + F[..., 2, 1, None] * y + F[..., 2, 2, None]
    lp0 = F[..., 0, 0, None] * u + F[..., 1, 0, None] * v + F[..., 2, 0, None]
    lp1 = F[..., 0, 1, None] * u + F[..., 1, 1, None] * v + F[..., 2, 1, None]
    num = u * l0 + v * l1 + l2
    den = l0 * l0 + l1 * l1 + lp0 * lp0 + lp1 * lp1
    return num * num / torch.clamp(den, min=1e-12)
