"""Nister/Stewenius five-point minimal essential-matrix solver
(``geometry/fivepoint.py`` of the JAX package), batched over any leading
axes (one per hypothesis) where the JAX package ``vmap``s.

1. The 4-D null space of the 5x9 epipolar system from the 9x9 Jacobi
   eigendecomposition of ``A^T A``: E = x E1 + y E2 + z E3 + E4.
2. The ten cubic constraints (det E = 0, 2 E E^T E - tr(E E^T) E = 0)
   evaluated at 20 fixed sample points and mapped to the 20 monomial
   coefficients by a constant inverse built with numpy from the same seed
   (``default_rng(3)``) as the JAX file.
3. Gauss-Jordan elimination as one batched 10x10 solve, Nister's rows
   <k>, <l>, <m> and det B(z), a degree-10 polynomial.
4. Its ten roots by 60 Durand-Kerner iterations on explicit (re, im)
   pairs, as the JAX file carries them, then six real Newton steps and a
   residual test that keeps the real roots.
5. (x, y) per root from the largest cross product of B(z)'s rows.

The eigenbasis of step 1 is only fixed up to a rotation within the null
space, so step 1-4 intermediates need not equal the JAX package's; the
candidate essential matrices do, as a set.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..features import topk_desc_stable
from ..utils.precision import device_constant, f32
from .linalg import sorted_eigh

# Nister's monomial order: 0:x3 1:y3 2:x2y 3:xy2 4:x2z 5:x2 6:y2z 7:y2 8:xyz
# 9:xy 10:xz2 11:xz 12:x 13:yz2 14:yz 15:y 16:z3 17:z2 18:z 19:1
_EXPONENTS = np.array(
    [
        (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
        (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
        (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
        (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
    ]
)
_SAMPLES = np.random.default_rng(3).standard_normal((20, 3))
_MONO = np.prod(_SAMPLES[:, None, :] ** _EXPONENTS[None, :, :], axis=-1)
_MONO_INV_T = np.linalg.inv(_MONO).T.astype(np.float32)   # (20, 20)
_SAMPLES_F32 = _SAMPLES.astype(np.float32)


def _trace_constraints(E: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 10): the nine entries of 2 E E^T E - tr(E E^T) E
    and det E."""
    EEt = E @ E.transpose(-1, -2)
    tr = EEt[..., 0, 0] + EEt[..., 1, 1] + EEt[..., 2, 2]
    C = 2.0 * (EEt @ E) - tr[..., None, None] * E
    return torch.cat([C.reshape(C.shape[:-2] + (9,)),
                      torch.linalg.det(E)[..., None]], dim=-1)


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full product of polynomials along the last axis (highest first)."""
    la, lb = a.shape[-1], b.shape[-1]
    out = torch.zeros(a.shape[:-1] + (la + lb - 1,), dtype=a.dtype, device=a.device)
    for i in range(la):
        out[..., i:i + lb] += a[..., i:i + 1] * b
    return out


def _poly_roots10(c: torch.Tensor, iters: int = 60):
    """All roots of degree-10 polynomials (coefficients (..., 11), highest
    first) by fixed-iteration Durand-Kerner: ``(re, im, ok)``, each root
    (..., 10); ok is False where the leading coefficient vanishes."""
    scale = torch.abs(c).amax(-1)
    ok = torch.abs(c[..., 0]) > 1e-9 * torch.clamp(scale, min=1e-30)
    cm = c / torch.where(ok, c[..., 0], 1e-9 * scale + 1e-30)[..., None]
    n = 10
    radius = 1.0 + torch.abs(cm[..., 1:]).amax(-1) ** (1.0 / n)
    k = torch.arange(n, dtype=torch.float32, device=c.device)
    theta = 2.0 * math.pi * (k + 0.35) / n
    wr0 = radius[..., None] * torch.cos(theta)
    wi0 = radius[..., None] * torch.sin(theta)
    eye = torch.eye(n, dtype=torch.float32, device=c.device)
    wr, wi = wr0, wi0
    for _ in range(iters):
        pr = cm[..., 0:1].expand(wr.shape)
        pi = torch.zeros_like(wi)
        for i in range(1, 11):
            pr, pi = pr * wr - pi * wi + cm[..., i:i + 1], pr * wi + pi * wr
        # The correction p / prod_{j != k}(w_k - w_j) by one safe division
        # per factor: the product itself overflows fp32 when iterates roam.
        dr = wr[..., :, None] - wr[..., None, :] + eye
        di = wi[..., :, None] - wi[..., None, :]
        cr, ci = pr, pi
        for j in range(n):
            a, b = dr[..., j], di[..., j]
            den = torch.clamp(a * a + b * b, min=1e-30)
            cr, ci = (cr * a + ci * b) / den, (ci * a - cr * b) / den
        wr_n, wi_n = wr - cr, wi - ci
        # A root that went non-finite restarts on the initial circle.
        fin = torch.isfinite(wr_n) & torch.isfinite(wi_n)
        wr = torch.where(fin, wr_n, wr0)
        wi = torch.where(fin, wi_n, wi0)
    return wr, wi, ok


def _horner(coef: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Polynomial (coefficients (..., d), highest first) at z (..., m)."""
    p = coef[..., 0:1].expand(z.shape)
    for i in range(1, coef.shape[-1]):
        p = p * z + coef[..., i:i + 1]
    return p


@f32
def essential_from_five(src: torch.Tensor, dst: torch.Tensor):
    """Up to 10 essential matrices from (..., 5, 2) normalised camera
    coordinates, ``dst_h^T E src_h = 0``: ``(E (..., 10, 3, 3), valid
    (..., 10))``; invalid slots are zeros."""
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    A = torch.stack([u * x, u * y, u, v * x, v * y, v, x, y, torch.ones_like(x)], dim=-1)
    batch = A.shape[:-2]

    _, V = sorted_eigh(A.transpose(-1, -2) @ A)
    basis = V[..., :, :4].transpose(-1, -2).reshape(batch + (4, 3, 3))
    E1, E2, E3, E4 = (basis[..., i, None, :, :] for i in range(4))

    t = device_constant(_SAMPLES_F32, A.device)[:, :, None, None]
    Es = t[:, 0] * E1 + t[:, 1] * E2 + t[:, 2] * E3 + E4        # (..., 20, 3, 3)
    vals = _trace_constraints(Es)                                # (..., 20, 10)
    coeffs = vals.transpose(-1, -2) @ device_constant(_MONO_INV_T, A.device)
    At = torch.linalg.solve(coeffs[..., :10], coeffs[..., 10:])  # (..., 10, 10)

    def row_pair(a, b):
        px = torch.stack([-b[..., 0], a[..., 0] - b[..., 1], a[..., 1] - b[..., 2],
                          a[..., 2]], dim=-1)
        py = torch.stack([-b[..., 3], a[..., 3] - b[..., 4], a[..., 4] - b[..., 5],
                          a[..., 5]], dim=-1)
        p1 = torch.stack([-b[..., 6], a[..., 6] - b[..., 7], a[..., 7] - b[..., 8],
                          a[..., 8] - b[..., 9], a[..., 9]], dim=-1)
        return px, py, p1

    kx, ky, k1 = row_pair(At[..., 4, :], At[..., 5, :])
    lx, ly, l1 = row_pair(At[..., 6, :], At[..., 7, :])
    mx, my, m1 = row_pair(At[..., 8, :], At[..., 9, :])
    t1 = _conv(ly, m1) - _conv(my, l1)
    t2 = _conv(lx, m1) - _conv(mx, l1)
    t3 = _conv(lx, my) - _conv(mx, ly)
    n10 = _conv(kx, t1) - _conv(ky, t2) + _conv(k1, t3)            # (..., 11)

    re, _, poly_ok = _poly_roots10(n10)

    # Real Newton polish, then keep a root whose polished value annihilates
    # the polynomial relative to its |coefficient|-majorised magnitude.
    lead = torch.where(poly_ok, n10[..., 0], torch.ones_like(n10[..., 0]))
    cmono = n10 / lead[..., None]
    z = re
    for _ in range(6):
        p = cmono[..., 0:1].expand(z.shape)
        dp = torch.zeros_like(z)
        for i in range(1, 11):
            dp = dp * z + p
            p = p * z + cmono[..., i:i + 1]
        z = z - p / torch.where(torch.abs(dp) > 1e-20, dp, torch.ones_like(dp))
    p = _horner(cmono, z)
    pa = _horner(torch.abs(cmono), torch.abs(z))
    is_real = torch.abs(p) <= 1e-3 * torch.clamp(pa, min=1e-20)

    z2 = z * z
    one = torch.ones_like(z)
    pz3 = torch.stack([z2 * z, z2, z, one], dim=-1)                 # (..., 10, 4)
    pz4 = torch.stack([z2 * z2, z2 * z, z2, z, one], dim=-1)

    def ev(pz, coef):
        return (pz @ coef[..., :, None])[..., 0]

    Bz = torch.stack([
        torch.stack([ev(pz3, kx), ev(pz3, ky), ev(pz4, k1)], dim=-1),
        torch.stack([ev(pz3, lx), ev(pz3, ly), ev(pz4, l1)], dim=-1),
        torch.stack([ev(pz3, mx), ev(pz3, my), ev(pz4, m1)], dim=-1),
    ], dim=-2)                                                      # (..., 10, 3, 3)
    cross = torch.linalg.cross
    crosses = torch.stack([
        cross(Bz[..., 0, :], Bz[..., 1, :], dim=-1),
        cross(Bz[..., 0, :], Bz[..., 2, :], dim=-1),
        cross(Bz[..., 1, :], Bz[..., 2, :], dim=-1),
    ], dim=-2)
    pick = torch.argmax(torch.linalg.vector_norm(crosses, dim=-1), dim=-1)
    vvec = torch.gather(crosses, -2, pick[..., None, None].expand(
        pick.shape + (1, 3)))[..., 0, :]
    w_ok = torch.abs(vvec[..., 2]) > 1e-12
    wsafe = torch.where(w_ok, vvec[..., 2], torch.ones_like(vvec[..., 2]))
    xs, ys = vvec[..., 0] / wsafe, vvec[..., 1] / wsafe

    E = (xs[..., None, None] * E1 + ys[..., None, None] * E2
         + z[..., None, None] * E3 + E4)                            # (..., 10, 3, 3)
    norm = torch.linalg.vector_norm(E.reshape(E.shape[:-2] + (9,)), dim=-1)
    E = E / torch.clamp(norm, min=1e-20)[..., None, None]
    valid = is_real & w_ok & poly_ok[..., None] & (norm > 1e-12)
    return torch.where(valid[..., None, None], E, torch.zeros_like(E)), valid


@f32
def fit_essential5(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor):
    """RANSAC adapter: the five points each (..., N) 0/1 weight row selects
    (the first five by weight, lower index first among ties, as
    ``lax.top_k``) through the minimal solver: ``((..., 10, 3, 3),
    (..., 10))``."""
    _, idx = topk_desc_stable(weights, 5)
    return essential_from_five(src[idx], dst[idx])
