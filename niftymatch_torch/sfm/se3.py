"""Batched SO(3)/SE(3) operations (``sfm/se3.py`` of the JAX package).

Conventions:
* Rotations are (..., 3, 3) matrices; poses are (R, t) pairs packed as
  (..., 3, 4) "Rt" matrices mapping world -> camera: x_cam = R x_world + t.
* Tangent vectors are (..., 6) = (rho, phi) with translation first,
  matching the common BA Jacobian layout.

Numerical design, as in the JAX file:
* Small-angle branches switch at theta = 0.1: below it the generic closed
  forms lose their fp32 precision to cancellation, and two-term Taylor
  series are accurate to ~1e-5 relative.
* Taylor branches are written in smooth quantities (theta^2 = sum(phi^2),
  2(1 - cos theta)), never in ``sqrt`` or ``arccos`` outputs, whose
  derivatives are inf at the identity.  Every branch is evaluated and
  ``torch.where`` picks one; in forward mode (``torch.func.jacfwd``, which
  the pose graphs and ``two_view_refine`` use) ``where`` picks the tangent
  element by element, so an inf in the discarded branch does not leak.
  Reverse mode would turn it into 0 * inf = NaN, so none of these maps is
  differentiated backwards.
* No function branches in Python on a tensor's values, so all of them run
  under ``torch.func.vmap``.
"""

from __future__ import annotations

import torch

from ..utils.precision import f32

_EPS = 1e-12
_SMALL = 0.1  # branch threshold on theta


def _eye3(like: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(shape)


def hat(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _exp_coeffs(th2: torch.Tensor):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (t-sin t)/t^3) from theta^2,
    smooth and fp32-stable on both sides of the branch."""
    small = th2 < _SMALL * _SMALL
    # Generic branch evaluated at a safe theta (discarded where small).
    th2_safe = torch.clamp(th2, min=_SMALL * _SMALL)
    t = torch.sqrt(th2_safe)
    A = torch.where(small, 1.0 - th2 / 6.0 + th2 * th2 / 120.0, torch.sin(t) / t)
    B = torch.where(
        small, 0.5 - th2 / 24.0 + th2 * th2 / 720.0, (1.0 - torch.cos(t)) / th2_safe
    )
    C = torch.where(
        small,
        1.0 / 6.0 - th2 / 120.0 + th2 * th2 / 5040.0,
        (t - torch.sin(t)) / (th2_safe * t),
    )
    return A, B, C


@f32
def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    th2 = (phi * phi).sum(-1)[..., None, None]
    K = hat(phi)
    K2 = K @ K
    A, B, _ = _exp_coeffs(th2)
    return _eye3(phi, K.shape) + A * K + B * K2


@f32
def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) axis-angle (|phi| <= pi)."""
    # Per-rotation scalars keep a trailing axis of 1: under vmap(jacfwd)
    # a 0-dim tensor times a Python number gets a float64 tangent.
    trace = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2])[..., None]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    # scale = theta / (2 sin theta); small branch in t2 = 2(1 - cos theta)
    # (smooth in R: no arccos, whose derivative blows up at theta = 0).
    t2 = 2.0 * (1.0 - cos_t)  # = theta^2 - theta^4/12 + ...
    small = t2 < _SMALL * _SMALL
    cos_safe = torch.clamp(cos_t, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_safe)
    generic = theta / torch.clamp(2.0 * torch.sin(theta), min=_EPS)
    taylor = 0.5 + t2 / 12.0 + t2 * t2 / 144.0
    main = torch.where(small, taylor, generic) * w
    # Near pi the vee vector w -> 0; recover the axis from the diagonal.
    near_pi = cos_t < -0.9999
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp((diag - cos_t) / torch.clamp(1.0 - cos_t, min=_EPS), min=0.0)
    axis = torch.sqrt(axis_sq)
    one = torch.ones_like(w)
    pi_branch = axis * torch.where(w >= 0.0, one, -one) * theta
    return torch.where(near_pi, pi_branch, main)


@f32
def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) = (rho, phi) -> (..., 3, 4) Rt."""
    rho, phi = xi[..., :3], xi[..., 3:]
    th2 = (phi * phi).sum(-1)[..., None, None]
    K = hat(phi)
    K2 = K @ K
    A, B, C = _exp_coeffs(th2)
    eye = _eye3(xi, K.shape)
    R = eye + A * K + B * K2
    V = eye + B * K + C * K2
    t = (V @ rho[..., None])[..., 0]
    return torch.cat([R, t[..., None]], dim=-1)


@f32
def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) Rt -> (..., 6)."""
    R, t = T[..., :3], T[..., 3]
    phi = so3_log(R)
    th2 = (phi * phi).sum(-1)[..., None, None]
    K = hat(phi)
    K2 = K @ K
    # V^-1 = I - K/2 + coef K^2 with coef = (1 - A/(2B)) / theta^2.
    # The generic form cancels catastrophically in fp32 below theta ~ 0.1;
    # the Taylor tail 1/12 + theta^2/720 is exact to ~1e-9 there.
    small = th2 < _SMALL * _SMALL
    th2_safe = torch.clamp(th2, min=_SMALL * _SMALL)
    th = torch.sqrt(th2_safe)
    A = torch.sin(th) / th
    B = (1.0 - torch.cos(th)) / th2_safe
    coef = torch.where(
        small,
        1.0 / 12.0 + th2 / 720.0 + th2 * th2 / 30240.0,
        (1.0 - A / (2.0 * B)) / th2_safe,
    )
    Vinv = _eye3(T, K.shape) - 0.5 * K + coef * K2
    rho = (Vinv @ t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def se3_identity(batch_shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    T = torch.cat([torch.eye(3, dtype=dtype, device=device),
                   torch.zeros((3, 1), dtype=dtype, device=device)], dim=-1)
    return T.expand(*batch_shape, 3, 4)


@f32
def se3_compose(Ta: torch.Tensor, Tb: torch.Tensor) -> torch.Tensor:
    """Ta * Tb (apply Tb first): (Ra Rb | Ra tb + ta)."""
    Ra, ta = Ta[..., :3], Ta[..., 3]
    Rb, tb = Tb[..., :3], Tb[..., 3]
    R = Ra @ Rb
    t = (Ra @ tb[..., None])[..., 0] + ta
    return torch.cat([R, t[..., None]], dim=-1)


@f32
def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    R, t = T[..., :3], T[..., 3]
    Rt = R.transpose(-1, -2)
    ti = -(Rt @ t[..., None])[..., 0]
    return torch.cat([Rt, ti[..., None]], dim=-1)


@f32
def se3_apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 3, 4) to points (..., N, 3) (or (..., 3))."""
    R, t = T[..., :3], T[..., 3]
    if pts.dim() == R.dim() - 1:  # single point per pose (a shape test)
        return (R @ pts[..., None])[..., 0] + t
    return pts @ R.transpose(-1, -2) + t[..., None, :]


@f32
def se3_relative(Ta: torch.Tensor, Tb: torch.Tensor) -> torch.Tensor:
    """T_ab = Ta^-1 * Tb (pose of b in a's frame)."""
    return se3_compose(se3_inverse(Ta), Tb)


@f32
def camera_center(T: torch.Tensor) -> torch.Tensor:
    """World-frame camera center -R^T t of world->cam poses (..., 3, 4)."""
    R, t = T[..., :3], T[..., 3]
    return -(R.transpose(-1, -2) @ t[..., None])[..., 0]
