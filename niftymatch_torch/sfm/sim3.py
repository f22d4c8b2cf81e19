"""Sim(3): similarity transforms for scale-drift-aware monocular SLAM
(``sfm/sim3.py`` of the JAX package; Strasdat et al., "Scale Drift-Aware
Large Scale Monocular SLAM", RSS 2010).

Representation: ``(s, T)`` with scalar scale ``s`` and ``T = [R | t]``
(3, 4); action ``x -> s R x + t``.  The GN retraction is component-wise
(SO(3) exp for the rotation block, additive translation, exponential
scale), a valid chart around the identity.  The functions take one node
or edge; batches go through ``torch.func.vmap``, as the JAX package's go
through ``jax.vmap``.
"""

from __future__ import annotations

import torch

from ..utils.precision import f32
from .se3 import so3_exp, so3_log


@f32
def sim3_compose(sa, Ta, sb, Tb):
    """(sa, Ta) o (sb, Tb): x -> sa Ra (sb Rb x + tb) + ta."""
    Ra, ta = Ta[..., :3], Ta[..., 3]
    Rb, tb = Tb[..., :3], Tb[..., 3]
    R = Ra @ Rb
    t = sa * (Ra @ tb[..., None])[..., 0] + ta
    return sa * sb, torch.cat([R, t[..., None]], dim=-1)


@f32
def sim3_inverse(s, T):
    R, t = T[..., :3], T[..., 3]
    s_inv = torch.reciprocal(s)  # not 1.0 / s: see se3.so3_log on 0-dim tangents
    Rt = R.transpose(-1, -2)
    t_inv = -s_inv * (Rt @ t[..., None])[..., 0]
    return s_inv, torch.cat([Rt, t_inv[..., None]], dim=-1)


@f32
def sim3_apply(s, T, pts):
    """pts (..., 3) -> s R pts + t."""
    R, t = T[..., :3], T[..., 3]
    return s * (pts @ R.transpose(-1, -2)) + t


@f32
def sim3_retract(xi, s, T):
    """Left retraction by tangent xi = (rho(3), phi(3), sigma(1))."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    dR = so3_exp(phi)
    dT = torch.cat([dR, rho[..., None]], dim=-1)
    return sim3_compose(torch.exp(sigma), dT, s, T)


@f32
def sim3_error(s, T):
    """(7,) component-wise error of a near-identity sim3: zero iff
    (s, T) == identity.  Used as the edge residual metric."""
    return torch.cat([T[..., 3], so3_log(T[..., :3]), torch.log(s)[..., None]], dim=-1)
