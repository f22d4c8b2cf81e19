"""Nonlinear two-view refinement: Gauss-Newton on the (R, t) manifold
(``sfm/two_view_refine.py`` of the JAX package).

A small Gauss-Newton on the 5-DoF relative pose (3 rotation tangents + 2
translation-sphere tangents) minimising the Sampson epipolar error over
the inlier correspondences: the step between RANSAC's minimal-sample E and
bundle adjustment.  Fixed iteration count, accept/reject by ``torch.where``
on the device; the Jacobian is forward mode (``torch.func.jacfwd``), as the
JAX file's ``jax.jacfwd``.

CPU tensors run that code, the plain version.  CUDA tensors run the whole
polish as one kernel (``kernels/refine.py``, ``csrc/refine.cu``) with an
analytic Jacobian: the plain version's ~590 launches a step left the SLAM
loop bound by the host's launch rate.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from ..geometry.linalg import cholesky_solve_small
from ..kernels import refine as _kernel
from ..utils.precision import f32
from ..utils.profiling import count
from .se3 import hat, so3_exp


def _essential_from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return hat(t) @ R


def _sampson_residuals(E, pts_a, pts_b):
    """Signed Sampson residual per correspondence (N,)."""
    x, y = pts_a[..., 0], pts_a[..., 1]
    u, v = pts_b[..., 0], pts_b[..., 1]
    l0 = E[0, 0] * x + E[0, 1] * y + E[0, 2]
    l1 = E[1, 0] * x + E[1, 1] * y + E[1, 2]
    l2 = E[2, 0] * x + E[2, 1] * y + E[2, 2]
    lp0 = E[0, 0] * u + E[1, 0] * v + E[2, 0]
    lp1 = E[0, 1] * u + E[1, 1] * v + E[2, 1]
    num = u * l0 + v * l1 + l2
    den = torch.sqrt(torch.clamp(l0 * l0 + l1 * l1 + lp0 * lp0 + lp1 * lp1, min=1e-12))
    return num / den


def _tangent_basis(t: torch.Tensor) -> torch.Tensor:
    """Two unit vectors orthogonal to t (columns of a (3, 2) basis)."""
    # The axis least aligned with t gives a stable first cross product.
    e = torch.eye(3, dtype=t.dtype, device=t.device)
    ref = torch.where(torch.abs(t[0]) < 0.9, e[0], e[1])
    b1 = torch.linalg.cross(t, ref, dim=-1)
    b1 = b1 / torch.clamp(torch.linalg.vector_norm(b1), min=1e-12)
    b2 = torch.linalg.cross(t, b1, dim=-1)
    b2 = b2 / torch.clamp(torch.linalg.vector_norm(b2), min=1e-12)
    return torch.stack([b1, b2], dim=-1)


def _retract_t(t: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    tn = t + _tangent_basis(t) @ dt
    return tn / torch.clamp(torch.linalg.vector_norm(tn), min=1e-12)


@f32
def refine_relative_pose(R0, t0, pts_a, pts_b, weights, iterations: int = 10,
                         damping: float = 1e-6):
    """Refine (R, t) minimising weighted Sampson error.

    Args:
      R0, t0: initial rotation / unit translation (x_b ~ R x_a + t).
      pts_a, pts_b: (N, 2) normalised correspondences.
      weights: (N,) inlier weights (0/1 or robust).
      iterations: fixed GN iterations (accept/reject on the device).

    Returns (R, t, final_cost)."""
    count("refine.calls")
    if R0.device.type == "cuda":
        count("refine.fused")
        return _kernel.refine_relative_pose(R0, t0, pts_a, pts_b, weights,
                                            iterations, damping)
    return refine_relative_pose_plain(R0, t0, pts_a, pts_b, weights,
                                      iterations, damping)


@f32
def refine_relative_pose_plain(R0, t0, pts_a, pts_b, weights,
                               iterations: int = 10, damping: float = 1e-6):
    """:func:`refine_relative_pose` in plain PyTorch on any device: the
    kernel's counterpart, which CPU tensors take."""
    w = weights
    sw = torch.sqrt(torch.clamp(w, min=0.0))

    def cost_of(R, t):
        r = _sampson_residuals(_essential_from_rt(R, t), pts_a, pts_b)
        return (w * r * r).sum()

    def residuals_of(params, R, t):
        Rp = so3_exp(params[:3]) @ R
        E = _essential_from_rt(Rp, _retract_t(t, params[3:]))
        return sw * _sampson_residuals(E, pts_a, pts_b)

    R, t = R0, t0
    lam = torch.full((), damping, dtype=R0.dtype, device=R0.device)
    cost = cost_of(R0, t0)
    zero = torch.zeros((5,), dtype=R0.dtype, device=R0.device)
    eye5 = torch.eye(5, dtype=R0.dtype, device=R0.device)
    for _ in range(iterations):
        J = jacfwd(residuals_of)(zero, R, t)            # (N, 5)
        r = residuals_of(zero, R, t)                     # (N,)
        H = J.T @ J + (lam + 1e-9) * eye5
        g = J.T @ r
        step = -cholesky_solve_small(H, g)
        Rn = so3_exp(step[:3]) @ R
        tn = _retract_t(t, step[3:])
        new_cost = cost_of(Rn, tn)
        accept = new_cost < cost
        R = torch.where(accept, Rn, R)
        t = torch.where(accept, tn, t)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 10.0), 1e-10, 1e4)
    return R, t, cost
