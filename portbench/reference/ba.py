"""Plain reference of global bundle adjustment: Levenberg-Marquardt whose
steps are solved by Schur-reduced preconditioned conjugate gradients, in
float64, and the observation table the ``ba`` traffic's problems are made
from.  Plain PyTorch; it imports neither JAX nor the measured program.

What it follows (the problem of BASELINE config 5 as ``bundle_adjust_cg``
states it):

* Pinhole residuals: a world point X seen by the camera (R, t) lies at
  p = R X + t; with z = p_z (1e-6 where |p_z| <= 1e-6) it projects to
  (fx p_x / z + cx, fy p_y / z + cy), and the residual is that minus the
  observed pixel.  An observation counts where it is valid and p_z > 1e-6.
* Huber's cost with ``huber_delta`` d: |r|^2 / 2 within d, d (|r| - d / 2)
  beyond; the Gauss-Newton system whitens each residual and Jacobian by
  the square root of the IRLS weight (1 within d, d / |r| beyond).
* The step: poses are moved on the left, T <- exp(xi) T, with xi = (rho,
  phi) and exp the SE(3) exponential (translation through V); points move
  by dX.  The Jacobians are those of that update.  The first poses of
  ``pose_fixed`` take no step.
* ``max_iterations`` LM iterations from the damping ``damping``: a step is
  kept iff it lowers the robust cost; the damping halves on a kept step and
  quadruples on a refused one, clamped to [1e-10, 1e6]; lam + 1e-8 is added
  to every camera and point diagonal block.
* Each step solves the reduced camera system S = H_cc - W H_ll^-1 W^T,
  applied without forming W or S, by PCG with the exact block-Jacobi
  preconditioner (S's 6 x 6 diagonal blocks, fixed poses as identity rows,
  + 1e-6 I), from zero, for exactly ``cg_iterations`` iterations, an
  iteration's update kept while the residual norm at its start was above
  ``cg_tol`` |rhs| (the freeze); then the points by back-substitution,
  dX = H_ll^-1 (b_l - W^T dxi).

Departures from the program (``niftymatch_torch/sfm/ba_cg.py``):

* float64 throughout, where the program computes in float32 with TF32 off;
* every sum over observations is ``index_add_`` (on the card float64
  atomics, in no fixed order), where the program sorts the observations
  once a solve and adds each camera's and each point's rows in order
  (``segment_reduce``) or takes blockwise prefix differences;
* the 3 x 3 and 6 x 6 inverses by ``torch.linalg.inv``, where the program
  takes the adjugate of the 3 x 3 blocks;
* the SE(3) exponential in closed form down to 1e-4 rad, where the program
  switches to Taylor series below 0.1 rad;
* the damping is float64, where the program's is float32.

The control (``lower=True``) is this reference one precision below the
configuration's: projections, residuals, weights, Jacobians and costs in
bfloat16 arithmetic, and every product of the Schur algebra (block sums,
applies, preconditioner) on operands rounded to TF32's 10-bit mantissa with
float32 sums, as the card's TF32 products are.

Limits of the ``solve`` mix (``portbench/traffic/solve.json``), each set
from card readings on the cell's own problems (H100: 40 problems of 10
seeds with the program, the control and the program with TF32 allowed
side by side, then 14 more runs of the program, 3 of the control and 2
of TF32 allowed through the cell's own check; ``PERF.md`` section 4 has
the runs).  The check reads every problem of the pool:

* ``cost0_gap`` 1e-5, the relative gap in the initial cost.  Both sides
  evaluate the same residuals once, so only float32 rounding of 2,097,152
  terms parts them: the program reads at most 9.6e-8; the control's
  bfloat16 pixels (spacing 1-2 px at 320 px) read 6.9e-3 and more.
* ``cost1_gap`` 6e-6, the relative gap in the cost after the first LM
  iteration, the median over the pool's 4 problems (each at its worst
  step).  Far from the minimum the cost's gradient at the stepped point is
  not zero, so the first cost moves first-order in the step's error, where
  the later costs, near the minimum, move second-order.  The program's
  median reads 4.0e-8-2.5e-6 over 24 runs (a problem alone up to 5.0e-6,
  hence the median); with TF32 allowed it reads 1.3e-5-3.9e-5 over 12 (a
  problem alone down to 3.0e-6); the control 0.57.  The limit is the
  geometric mean of the nearest two, 2.4x from each.
* ``cost_gap`` 1e-3, the largest relative gap over the six LM costs.  The
  program reads up to 4.6e-4.  Its tail above 1e-4 is where the two sides
  decide a later iteration's accept differently (2 of the 40 problems read
  side by side, 3.8e-4 and 4.5e-4): such a gap is bounded by that
  iteration's decrease, ~4.4e-4 of the cost for the third, since the
  second's (4 %) cannot flip.  The control reads 0.57 and more.
* ``pose_err`` 0.4, the largest pose entry's distance from the truth.
  The program reads 0.024-0.22 (the unconverged far cameras of the helix,
  ~27 units out), the poses the solves start from 0.72-0.92: the limit lies
  between them.  ``chip_smoke.py`` phase 7c's bar, 0.25, has too little
  room above 0.22 for runs on fresh seeds.  The poses are not held to the
  reference: at 6 x 24 iterations the cost does not fix them (the program
  and this reference part by 0.03-0.25; relabelling the points, which only
  reorders the program's sums, moves them by 1.7e-2).

The program with TF32 allowed (its blockwise prefix sums and block
products then add in TF32) breaks ``cost1_gap`` alone: its initial cost
is the program's to the bit (no product it allows touches the cost), its
worst cost gap reads 4.4e-6-7.9e-5 and its pose error 0.027-0.063.  The
control breaks ``cost0_gap``, ``cost1_gap`` and ``cost_gap``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Problem(NamedTuple):
    """A problem in ``BAProblem``'s field order: poses (C, 3, 4)
    world->camera, points (L, 3), intrinsics (4,) = (fx, fy, cx, cy),
    observations obs_uv (O, 2), obs_cam (O,), obs_lm (O,), obs_valid (O,),
    and pose_fixed (C,)."""

    poses: torch.Tensor
    points: torch.Tensor
    intrinsics: torch.Tensor
    obs_uv: torch.Tensor
    obs_cam: torch.Tensor
    obs_lm: torch.Tensor
    obs_valid: torch.Tensor
    pose_fixed: torch.Tensor


class Solution(NamedTuple):
    initial_cost: float
    costs: np.ndarray      # (max_iterations,) the cost after each iteration
    poses: torch.Tensor
    points: torch.Tensor


def observation_table(poses: torch.Tensor, points: torch.Tensor, intrinsics,
                      width: int, height: int, max_obs_per_cam: int,
                      gen: torch.Generator, cam_batch: int = 32):
    """``data/synthetic.make_observation_table``'s rule on the device: a
    camera sees the points with z > 0.1 that project inside the frame, and
    keeps ``max_obs_per_cam`` of them drawn at random without replacement
    (all of them if it sees fewer), in point order.  Returns the true
    pixels (O, 2) float32 and obs_cam, obs_lm (O,) int32."""
    fx, fy, cx, cy = (float(v) for v in intrinsics)
    L = points.shape[0]
    k = min(max_obs_per_cam, L)
    uv, cams, lms = [], [], []
    for c0 in range(0, poses.shape[0], cam_batch):
        T = poses[c0:c0 + cam_batch]
        p = points[None] @ T[:, :, :3].transpose(1, 2) + T[:, None, :, 3]   # (b, L, 3)
        z = p[..., 2]
        zc = torch.clamp(z, min=1e-9)
        u = fx * p[..., 0] / zc + cx
        v = fy * p[..., 1] / zc + cy
        seen = (z > 0.1) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
        keys = torch.rand(seen.shape, generator=gen, device=seen.device)
        keys = torch.where(seen, keys, torch.full_like(keys, 2.0))
        pick = keys.topk(k, dim=1, largest=False).indices.sort(dim=1).values
        kept = keys.gather(1, pick) < 2.0
        rows = torch.arange(T.shape[0], device=seen.device)[:, None].expand_as(pick)
        b, lm = rows[kept], pick[kept]
        uv.append(torch.stack([u[b, lm], v[b, lm]], -1))
        cams.append((b + c0).to(torch.int32))
        lms.append(lm.to(torch.int32))
    return torch.cat(uv), torch.cat(cams), torch.cat(lms)


def hat(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) = (rho, phi) -> (..., 3, 4): R = I + A K + B K^2, t = (I + B K
    + C K^2) rho, with A = sin t / t, B = (1 - cos t) / t^2, C = (t - sin t)
    / t^3 (their series below 1e-4 rad)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    th = torch.linalg.vector_norm(phi, dim=-1)[..., None, None]
    small = th < 1e-4
    ts = torch.where(small, torch.ones_like(th), th)
    th2 = th * th
    A = torch.where(small, 1 - th2 / 6, torch.sin(ts) / ts)
    B = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(ts)) / (ts * ts))
    C = torch.where(small, 1 / 6 - th2 / 120, (ts - torch.sin(ts)) / (ts * ts * ts))
    K = hat(phi)
    K2 = K @ K
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(K.shape)
    R = eye + A * K + B * K2
    t = ((eye + B * K + C * K2) @ rho[..., None])[..., 0]
    return torch.cat([R, t[..., None]], -1)


def perturb(poses, points, fixed: int, pose_sigma: float, point_sigma: float,
            gen: torch.Generator):
    """Poses moved on the left by N(0, ``pose_sigma``) tangents (the first
    ``fixed`` left alone) and points by N(0, ``point_sigma``), float32."""
    dev = poses.device
    xi = torch.randn((poses.shape[0], 6), generator=gen, device=dev, dtype=torch.float64)
    xi = xi * pose_sigma
    xi[:fixed] = 0
    moved = _compose(se3_exp(xi), poses.double()).float()
    noise = torch.randn(points.shape, generator=gen, device=dev, dtype=torch.float64)
    return moved, (points.double() + point_sigma * noise).float()


def _compose(A, B):
    R = A[..., :3] @ B[..., :3]
    t = (A[..., :3] @ B[..., 3:])[..., 0] + A[..., 3]
    return torch.cat([R, t[..., None]], -1)


class _Precision(NamedTuple):
    lin: torch.dtype        # projection, residuals, weights, Jacobians, cost
    alg: torch.dtype        # sums, the Schur algebra, PCG, the state
    tf32: bool              # round the operands of every product to TF32


FULL = _Precision(torch.float64, torch.float64, False)
LOWER = _Precision(torch.bfloat16, torch.float32, True)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10-bit mantissa (to nearest)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(prec, eq, *ops):
    if prec.tf32:
        ops = [_tf32(o) for o in ops]
    return torch.einsum(eq, *ops)


def _sum_into(n, index, vals):
    out = torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, index, vals)


def _residuals(prob, state, prec):
    """Residuals (O, 2), camera-frame points (O, 3), z (O,), the counted
    mask (O,) and the rotations (O, 3, 3), all in ``prec.lin``."""
    poses, points = (s.to(prec.lin) for s in state)
    T = poses[prob.obs_cam.long()]
    X = points[prob.obs_lm.long()]
    p = (T[..., :3] @ X[..., None])[..., 0] + T[..., 3]
    z = torch.where(p[..., 2].abs() > 1e-6, p[..., 2], torch.full_like(p[..., 2], 1e-6))
    f = prob.intrinsics.to(prec.lin)
    uv = torch.stack([f[0] * p[..., 0] / z + f[2], f[1] * p[..., 1] / z + f[3]], -1)
    r = uv - prob.obs_uv.to(prec.lin)
    counted = prob.obs_valid & (p[..., 2] > 1e-6)
    return r, p, z, counted, T[..., :3]


def cost(prob, state, prec=FULL, delta=2.0) -> torch.Tensor:
    r, _, _, counted, _ = _residuals(prob, state, prec)
    n2 = (r * r).sum(-1)
    n = torch.sqrt(torch.clamp(n2, min=1e-18))
    c = torch.where(n <= delta, 0.5 * n2, delta * (n - 0.5 * delta))
    return (c.to(prec.alg) * counted.to(prec.alg)).sum()


def _linearize(prob, state, prec, delta):
    """Whitened Jacobians J_c (O, 2, 6), J_l (O, 2, 3) and residuals (O, 2),
    in ``prec.alg``."""
    r, p, z, counted, R = _residuals(prob, state, prec)
    norm = torch.linalg.vector_norm(r, dim=-1)
    w = torch.where(norm <= delta, torch.ones_like(norm), delta / torch.clamp(norm, min=1e-12))
    sw = torch.sqrt(w * counted.to(w.dtype))
    f = prob.intrinsics.to(prec.lin)
    iz = 1.0 / z
    o = torch.zeros_like(z)
    dproj = torch.stack([torch.stack([f[0] * iz, o, -f[0] * p[..., 0] * iz * iz], -1),
                         torch.stack([o, f[1] * iz, -f[1] * p[..., 1] * iz * iz], -1)], -2)
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(p.shape[:-1] + (3, 3))
    J_c = dproj @ torch.cat([eye, -hat(p)], -1)
    J_l = dproj @ R
    a = prec.alg
    return ((J_c * sw[:, None, None]).to(a), (J_l * sw[:, None, None]).to(a),
            (r * sw[:, None]).to(a))


def _step(prob, state, lam, ba, prec):
    """One damped Gauss-Newton step by Schur-reduced PCG: (dxi (C, 6), dX (L, 3))."""
    poses, points = state
    C, L = poses.shape[0], points.shape[0]
    cam, lm = prob.obs_cam.long(), prob.obs_lm.long()
    Jc, Jl, rw = _linearize(prob, state, prec, ba["huber_delta"])
    a, dev = prec.alg, poses.device
    eye6 = torch.eye(6, dtype=a, device=dev)
    eye3 = torch.eye(3, dtype=a, device=dev)
    damp = lam + 1e-8
    Hcc = _sum_into(C, cam, _mm(prec, "oij,oik->ojk", Jc, Jc)) + damp * eye6
    Hll = _sum_into(L, lm, _mm(prec, "oij,oik->ojk", Jl, Jl)) + damp * eye3
    Hll_inv = torch.linalg.inv(Hll)
    b_c = -_sum_into(C, cam, _mm(prec, "oij,oi->oj", Jc, rw))
    b_l = -_sum_into(L, lm, _mm(prec, "oij,oi->oj", Jl, rw))
    free = (~prob.pose_fixed).to(a)[:, None]

    def wt(v):                       # W^T v: (C, 6) -> (L, 3)
        return _sum_into(L, lm, _mm(prec, "oij,oi->oj", Jl, _mm(prec, "oij,oj->oi", Jc, v[cam])))

    def w(y):                        # W y: (L, 3) -> (C, 6)
        return _sum_into(C, cam, _mm(prec, "oij,oi->oj", Jc, _mm(prec, "oij,oj->oi", Jl, y[lm])))

    def hinv(y):
        return _mm(prec, "lij,lj->li", Hll_inv, y)

    def S(v):
        v = v * free
        out = (_mm(prec, "cij,cj->ci", Hcc, v) - w(hinv(wt(v)))) * free
        return out + v * (1 - free)

    rhs = (b_c - w(hinv(b_l))) * free
    A = _mm(prec, "oic,oil->ocl", Jc, Jl)
    G = _mm(prec, "ocl,olm,odm->ocd", A, Hll_inv[lm], A)
    P = torch.where(prob.pose_fixed[:, None, None], eye6, Hcc - _sum_into(C, cam, G))
    P_inv = torch.linalg.inv(P + 1e-6 * eye6)

    def precond(v):
        return _mm(prec, "cij,cj->ci", P_inv, v)

    rhs_norm = torch.sqrt((rhs * rhs).sum())
    tol = ba["cg_tol"] * torch.clamp(rhs_norm, min=1e-30)
    x = torch.zeros_like(rhs)
    r = rhs
    p = precond(r)
    rz = (r * p).sum()
    active = rhs_norm > 0
    for _ in range(ba["cg_iterations"]):
        Ap = S(p)
        den = (p * Ap).sum()
        alpha = rz / torch.where(den.abs() > 1e-30, den, torch.ones_like(den))
        x_n, r_n = x + alpha * p, r - alpha * Ap
        z_n = precond(r_n)
        rz_n = (r_n * z_n).sum()
        beta = rz_n / torch.where(rz.abs() > 1e-30, rz, torch.ones_like(rz))
        p_n = z_n + beta * p
        keep = active & (torch.sqrt((r_n * r_n).sum()) > tol)
        x = torch.where(active, x_n, x)
        r = torch.where(active, r_n, r)
        p = torch.where(active, p_n, p)
        rz = torch.where(active, rz_n, rz)
        active = keep
    dxi = x * free
    return dxi, hinv(b_l - wt(dxi))


def solve(prob: Problem, ba: dict, lower: bool = False) -> Solution:
    """``ba["max_iterations"]`` LM iterations on ``prob`` (the keys of
    ``BAConfig``), in float64, or one precision below with ``lower``."""
    prec = LOWER if lower else FULL
    a = prec.alg
    state = (prob.poses.to(a), prob.points.to(a))
    delta = ba["huber_delta"]
    c = cost(prob, state, prec, delta)
    c0 = c
    lam = torch.tensor(ba["damping"], dtype=a, device=prob.poses.device)
    costs = []
    for _ in range(ba["max_iterations"]):
        dxi, dX = _step(prob, state, lam, ba, prec)
        cand = (_compose(se3_exp(dxi), state[0]), state[1] + dX)
        c_new = cost(prob, cand, prec, delta)
        keep = c_new < c
        state = tuple(torch.where(keep, n, s) for n, s in zip(cand, state))
        c = torch.where(keep, c_new, c)
        lam = torch.clamp(torch.where(keep, lam * 0.5, lam * 4.0), 1e-10, 1e6)
        costs.append(c)
    return Solution(float(c0), torch.stack(costs).double().cpu().numpy(),
                    state[0], state[1])
