"""Bundle adjustment: Schur-complement Levenberg-Marquardt, fully batched
(``sfm/ba.py`` of the JAX package), the dense solver for sliding windows.

* The observation set is a fixed-capacity table (obs_uv / obs_cam / obs_lm /
  obs_valid): static shapes, masks instead of compaction.
* Per-observation analytic Jacobians are computed batched; the block
  reductions (J^T J, J^T r) are exact per-segment sums keyed by camera,
  landmark or (camera, landmark) pair, the counterpart of
  ``jax.ops.segment_sum``: the ids are sorted once per ``bundle_adjust``
  call (``obs_cam``/``obs_lm`` do not change between LM iterations) and
  each segment's rows are added in order by ``torch.segment_reduce``, so
  two runs on the card give the same bits (no float atomics).
* Landmark blocks are 3x3 and inverted by the adjugate; the reduced camera
  system S = H_cc - W H_ll^-1 W^T is one GEMM over landmarks and is solved
  densely (6C x 6C, C = window size) with ``torch.linalg.solve_ex``, which
  does not check for singularity and so never waits on the host.
* The LM loop is a Python loop over a fixed count whose accept/reject,
  damping and cost stay on the device (``torch.where``): no host syncs.
  ``W`` is (C, L, 6, 3), O(C L) memory: beyond ~16 cameras use
  ``ba_cg.bundle_adjust_cg``.

Gauge freedom is fixed by a ``pose_fixed`` mask (rows/cols of fixed poses
are pinned to identity in S).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import BAConfig
from ..geometry.linalg import inv3x3
from ..utils.precision import f32, resolve_device, state_to
from .se3 import hat, se3_compose, se3_exp


class BAProblem(NamedTuple):
    """Fixed-shape bundle-adjustment state.

    poses: (C, 3, 4) world->camera.  landmarks: (L, 3) world points.
    intrinsics: (4,) = (fx, fy, cx, cy).  Observations are a flat table:
    obs_uv (O, 2) pixels, obs_cam/obs_lm (O,) int32, obs_valid (O,) bool.
    pose_fixed: (C,) bool gauge mask (at least one True).
    """

    poses: torch.Tensor
    landmarks: torch.Tensor
    intrinsics: torch.Tensor
    obs_uv: torch.Tensor
    obs_cam: torch.Tensor
    obs_lm: torch.Tensor
    obs_valid: torch.Tensor
    pose_fixed: torch.Tensor


@f32
def project(poses, landmarks, intrinsics, obs_cam, obs_lm):
    """Per-observation pinhole projection.  Returns (uv (O, 2), p_cam (O, 3))."""
    T = poses[obs_cam]                      # (O, 3, 4)
    X = landmarks[obs_lm]                   # (O, 3)
    p = (T[..., :3] @ X[..., None])[..., 0] + T[..., 3]
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    z = torch.where(torch.abs(p[..., 2]) > 1e-6, p[..., 2], 1e-6)
    u = fx * p[..., 0] / z + cx
    v = fy * p[..., 1] / z + cy
    return torch.stack([u, v], dim=-1), p


@f32
def residuals_and_weights(problem: BAProblem, huber_delta: float):
    """Reprojection residuals (O, 2) + Huber IRLS weights (O,)."""
    uv, p = project(problem.poses, problem.landmarks, problem.intrinsics,
                    problem.obs_cam, problem.obs_lm)
    r = uv - problem.obs_uv
    # Observations behind the camera get zero weight (cheirality guard).
    valid = problem.obs_valid & (p[..., 2] > 1e-6)
    norm = torch.linalg.vector_norm(r, dim=-1)
    w = torch.where(norm <= huber_delta, 1.0,
                    huber_delta / torch.clamp(norm, min=1e-12))
    w = w * valid.to(torch.float32)
    return r, w, p, valid


@f32
def ba_cost(problem: BAProblem, huber_delta: float) -> torch.Tensor:
    """Total robust (Huber) cost."""
    r, w, _, valid = residuals_and_weights(problem, huber_delta)
    n2 = (r * r).sum(-1)
    n = torch.sqrt(torch.clamp(n2, min=1e-18))
    quad = 0.5 * n2
    lin = huber_delta * (n - 0.5 * huber_delta)
    cost = torch.where(n <= huber_delta, quad, lin)
    return (cost * valid.to(torch.float32)).sum()


def _jacobians(problem: BAProblem, p: torch.Tensor):
    """Analytic per-observation Jacobians.

    J_pose (O, 2, 6) wrt left-multiplied tangent exp(xi) T (rho, phi order);
    J_lm (O, 2, 3) wrt the world point."""
    fx, fy = problem.intrinsics[0], problem.intrinsics[1]
    x, y = p[..., 0], p[..., 1]
    z = torch.where(torch.abs(p[..., 2]) > 1e-6, p[..., 2], 1e-6)
    iz = 1.0 / z
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    dproj = torch.stack(                               # d(u,v)/dp (O, 2, 3)
        [
            torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1),
            torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1),
        ],
        dim=-2,
    )
    # dp/dxi = [I | -hat(p)]  (O, 3, 6)
    I3 = torch.eye(3, dtype=p.dtype, device=p.device).expand(*p.shape[:-1], 3, 3)
    dp_dxi = torch.cat([I3, -hat(p)], dim=-1)
    J_pose = dproj @ dp_dxi                            # (O, 2, 6)
    R = problem.poses[problem.obs_cam][..., :3]        # (O, 3, 3)
    J_lm = dproj @ R                                   # (O, 2, 3)
    return J_pose, J_lm


class BAStats(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    lambdas: torch.Tensor       # (iters,) damping trace
    costs: torch.Tensor         # (iters,) accepted cost after each iteration


class Segments(NamedTuple):
    """Rows grouped by id for :func:`segment_sum`: ``perm`` puts the rows
    in stable order of their ids, ``lengths`` counts each id's rows."""

    perm: torch.Tensor      # (O,) int64
    lengths: torch.Tensor   # (num,) int64


def sorted_segments(ids: torch.Tensor, num: int) -> Segments:
    """The :class:`Segments` of ids in [0, num), in any order: a stable
    sort and a left-side ``searchsorted`` of each segment's end (not
    ``bincount``, which reads the largest id on the host on CUDA)."""
    sorted_ids, perm = torch.sort(ids.long(), stable=True)
    ends = torch.searchsorted(sorted_ids, torch.arange(1, num + 1, device=ids.device))
    return Segments(perm=perm, lengths=torch.diff(ends, prepend=ends.new_zeros(1)))


def segment_sum(vals: torch.Tensor, seg: Segments) -> torch.Tensor:
    """Exact per-segment sum of (O, ...) rows into (num, ...): each
    segment's rows added in the order of ``seg.perm``, deterministic on
    the card (no atomics); an empty segment sums to 0."""
    return torch.segment_reduce(vals[seg.perm], "sum", lengths=seg.lengths,
                                axis=0, unsafe=True)


class BlockSegments(NamedTuple):
    """The observations grouped by camera, by landmark and by (camera,
    landmark) pair: fixed for a problem, so built once per solve."""

    cam: Segments
    lm: Segments
    pair: Segments


def block_segments(problem: BAProblem) -> BlockSegments:
    C, L = problem.poses.shape[0], problem.landmarks.shape[0]
    cam, lm = problem.obs_cam.long(), problem.obs_lm.long()
    return BlockSegments(cam=sorted_segments(cam, C), lm=sorted_segments(lm, L),
                         pair=sorted_segments(cam * L + lm, C * L))


def _solve_step(problem: BAProblem, lam: torch.Tensor, config: BAConfig,
                segs: BlockSegments | None = None):
    """One damped GN solve: returns (dxi (C, 6), dX (L, 3)).  ``segs``:
    the problem's :func:`block_segments`, built here when not given."""
    C = problem.poses.shape[0]
    L = problem.landmarks.shape[0]
    segs = block_segments(problem) if segs is None else segs

    r, w, p, _ = residuals_and_weights(problem, config.huber_delta)
    J_c, J_l = _jacobians(problem, p)
    sw = torch.sqrt(w)[..., None]
    r_w = r * sw
    J_c = J_c * sw[..., None]
    J_l = J_l * sw[..., None]

    # Block reductions (exact segment sums).
    Hcc = segment_sum(torch.einsum("oij,oik->ojk", J_c, J_c), segs.cam)    # (C, 6, 6)
    Hll = segment_sum(torch.einsum("oij,oik->ojk", J_l, J_l), segs.lm)     # (L, 3, 3)
    W = segment_sum(torch.einsum("oij,oik->ojk", J_c, J_l),
                    segs.pair).reshape(C, L, 6, 3)
    b_c = -segment_sum(torch.einsum("oij,oi->oj", J_c, r_w), segs.cam)     # (C, 6)
    b_l = -segment_sum(torch.einsum("oij,oi->oj", J_l, r_w), segs.lm)      # (L, 3)

    # LM damping (additive, keeps unobserved blocks invertible).
    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    eye3 = torch.eye(3, dtype=Hll.dtype, device=Hll.device)
    Hcc = Hcc + (lam + 1e-8) * eye6
    Hll = Hll + (lam + 1e-8) * eye3

    # Schur complement onto cameras: one GEMM over landmarks.
    Hll_inv = inv3x3(Hll)                                    # (L, 3, 3)
    A = torch.einsum("clij,ljk->clik", W, Hll_inv)           # (C, L, 6, 3)
    S_blocks = torch.einsum("clij,dlkj->cdik", A, W)         # (C, C, 6, 6)
    eyeC = torch.eye(C, dtype=Hcc.dtype, device=Hcc.device)[:, :, None, None]
    S = (eyeC * Hcc[:, None] - S_blocks).permute(0, 2, 1, 3).reshape(C * 6, C * 6)
    rhs = (b_c - torch.einsum("clij,lj->ci", A, b_l)).reshape(C * 6)

    # Gauge: pin fixed poses (identity rows/cols, zero rhs).
    fm = (~problem.pose_fixed).to(S.dtype).repeat_interleave(6)
    S = S * fm[:, None] * fm[None, :] + torch.diag(1.0 - fm)
    rhs = rhs * fm

    dxi = torch.linalg.solve_ex(S, rhs).result.reshape(C, 6)

    # Back-substitute landmarks: dX = Hll^-1 (b_l - W^T dxi summed over cams).
    Wt_dxi = torch.einsum("clij,ci->lj", W, dxi)              # (L, 3)
    dX = torch.einsum("lij,lj->li", Hll_inv, b_l - Wt_dxi)
    return dxi, dX


def _apply_step(problem: BAProblem, dxi, dX) -> BAProblem:
    free = (~problem.pose_fixed)[:, None].to(dxi.dtype)
    new_poses = se3_compose(se3_exp(dxi * free), problem.poses)
    return problem._replace(poses=new_poses, landmarks=problem.landmarks + dX)


def lm_loop(problem: BAProblem, init_cost: torch.Tensor, config: BAConfig,
            solve_step):
    """The LM loop of both solvers: ``config.max_iterations`` steps of
    ``solve_step(problem, lam) -> (dxi, dX)`` from ``init_cost``; a step is
    kept iff it lowers the robust cost, damping x0.5 / x4.  Accept, cost
    and damping stay on the device.  Returns (problem, BAStats)."""
    cost = init_cost
    lam = torch.full((), config.damping, dtype=torch.float32,
                     device=problem.poses.device)
    lams, costs = [], []
    for _ in range(config.max_iterations):
        cand = _apply_step(problem, *solve_step(problem, lam))
        new_cost = ba_cost(cand, config.huber_delta)
        accept = new_cost < cost
        problem = problem._replace(
            poses=torch.where(accept, cand.poses, problem.poses),
            landmarks=torch.where(accept, cand.landmarks, problem.landmarks),
        )
        cost = torch.where(accept, new_cost, cost)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e6)
        lams.append(lam)
        costs.append(cost)
    return problem, BAStats(initial_cost=init_cost, final_cost=cost,
                            lambdas=torch.stack(lams), costs=torch.stack(costs))


@f32
def bundle_adjust(problem: BAProblem, config: BAConfig = BAConfig(),
                  device=None) -> tuple[BAProblem, BAStats]:
    """Levenberg-Marquardt BA with Schur-complement camera solves.

    Fixed ``config.max_iterations`` iterations, branchless accept/reject:
    a step is kept iff it lowers the robust cost; damping follows the
    classic x0.5 / x4 schedule.  Runs on ``device`` (CUDA by default), to
    which the problem's fields are moved."""
    problem = state_to(problem, resolve_device(device))
    segs = block_segments(problem)
    return lm_loop(problem, ba_cost(problem, config.huber_delta), config,
                   lambda prob, lam: _solve_step(prob, lam, config, segs))
