"""Matrix-free Schur-complement PCG bundle adjustment at global-BA scale
(``sfm/ba_cg.py`` of the JAX package).

The dense window solver (``ba.py``) stores the camera-landmark coupling
``W`` as a (C, L, 6, 3) tensor, O(C L) memory; this solver never forms
``W`` or ``S``:

* One linearisation per LM iteration stores the per-observation whitened
  Jacobians ``J_c (O, 2, 6)`` / ``J_l (O, 2, 3)`` and residuals (O, 2),
  O(O) memory.  They stay rank-3: the JAX file keeps them flat ((O, 12),
  (O, 6)) and writes the block products out column by column
  (``_outer_flat``) because the TPU pads a rank-3 row to a whole tile;
  the card has no such padding, and each block product here is one batched
  ``einsum`` or matrix product; the per-row matrix-vector products of the
  CG applies are a broadcast product and a sum (``_mv``, ``_mtv``).
* The Schur operator ``S v = (H_cc + lam I) v - W (H_ll + lam I)^-1 W^T v``
  is applied in observation space: gathers plus sorted segment sums.
* Two kinds of segment sum, as in the JAX file (its ``docs/ARCHITECTURE.md``
  rule 7).  Inside the CG applies: cumsum differences over observations
  sorted by landmark (``_seg_reduce``; a segment's absolute error scales
  with the global fp32 prefix, acceptable for the signed summands of an
  iterative solve), the prefix sums taken blockwise in a fixed order
  (``_prefix_at``), so two runs on the card give the same bits.  For the
  once-per-iteration block sums that feed the 3x3 inverses and the preconditioner (all-positive quadratic terms):
  exact per-segment accumulation, ``torch.segment_reduce`` over the
  sorted segments' lengths (``seg_sum_lm_exact`` / ``seg_sum_cam_exact``).
  On CUDA it sums each segment's rows in order in one thread, so it is
  deterministic, unlike ``index_add_``'s float atomics.
* Preconditioner: the exact block-Jacobi of S.  A (camera, landmark) pair
  has at most one observation, so the diagonal correction
  ``sum_l W_cl H_ll^-1 W_cl^T`` is itself a segment sum over observations
  of ``(J_c^T J_l) H_ll^-1 (J_l^T J_c)``.
* PCG runs a fixed ``config.cg_iterations`` Python loop with a branchless
  convergence freeze at ``config.cg_tol``; the residual norms, step sizes
  and the ``active`` flag stay device tensors combined with
  ``torch.where``, so no iteration waits on the host.  The LM loop around
  it is the dense solver's (``ba.lm_loop``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..config import BAConfig
from ..geometry.linalg import inv3x3
from ..utils.precision import f32, resolve_device, state_to
from .ba import (
    BAProblem,
    BAStats,
    _jacobians,
    ba_cost,
    lm_loop,
    residuals_and_weights,
)


class ObsLayout(NamedTuple):
    """Sorted-observation layout for the segmented reductions.

    All per-observation arrays downstream live in BY-LANDMARK order;
    ``perm_to_cam`` maps them into by-camera order when a camera-side
    reduction is needed.  Indices are int64 (the JAX file's are int32;
    the values are the same)."""

    order_lm: torch.Tensor      # (O,) permutation: original -> by-landmark
    ends_lm: torch.Tensor       # (L,) exclusive end index per landmark
    perm_to_cam: torch.Tensor   # (O,) by-landmark -> by-camera
    ends_cam: torch.Tensor      # (C,) exclusive end index per camera
    cam_sorted: torch.Tensor    # (O,) camera id per by-landmark row
    lm_sorted: torch.Tensor     # (O,) landmark id per by-landmark row
    scan_lm: tuple              # ``_scan_plan`` of ends_lm
    scan_cam: tuple             # ``_scan_plan`` of ends_cam


def build_obs_layout(cam: torch.Tensor, lm: torch.Tensor, C: int, L: int
                     ) -> ObsLayout:
    """Once-per-solve index tables: stable device argsorts and left-side
    ``searchsorted``, as ``jnp.argsort(stable=True)`` and
    ``jnp.searchsorted``."""
    cam, lm = cam.long(), lm.long()
    order_lm = torch.argsort(lm, stable=True)
    lm_sorted = lm[order_lm]
    cam_in_lm = cam[order_lm]
    perm_to_cam = torch.argsort(cam_in_lm, stable=True)
    cam_sorted_by_cam = cam_in_lm[perm_to_cam]
    ends_lm = torch.searchsorted(lm_sorted, torch.arange(1, L + 1, device=lm.device))
    ends_cam = torch.searchsorted(cam_sorted_by_cam,
                                  torch.arange(1, C + 1, device=cam.device))
    O = cam.shape[0]
    return ObsLayout(order_lm=order_lm, ends_lm=ends_lm, perm_to_cam=perm_to_cam,
                     ends_cam=ends_cam, cam_sorted=cam_in_lm, lm_sorted=lm_sorted,
                     scan_lm=_scan_plan(ends_lm, O), scan_cam=_scan_plan(ends_cam, O))


# The blocks of ``_prefix_at``'s levels: 32 columns at the first, whose
# triangle product stays at the bytes' time, and 1,024 at every later one,
# so that two or three levels cover two million columns.
_SCAN_BLOCKS = (32, 1024)


@functools.lru_cache(maxsize=None)
def _ones_triangle(B: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """(B, B) ones on and above the diagonal: a row of a block times it is
    the block's inclusive prefix."""
    return torch.ones((B, B), dtype=dtype, device=device).triu_()


def _scan_plan(ends: torch.Tensor, O: int) -> tuple:
    """The columns :func:`_prefix_at` reads at each level when
    :func:`_seg_reduce` scans O rows behind a zero column: at the first,
    0 and each segment's end; at each later one, the block of the column
    read at the level before."""
    at = torch.nn.functional.pad(ends, (1, 0))
    plan, n = [at], O + 1
    for B in (_SCAN_BLOCKS[0], *[_SCAN_BLOCKS[1]] * 8):
        if n <= B:
            return tuple(plan)
        n = -(-n // B)
        at = torch.div(at, B, rounding_mode="floor")
        plan.append(at)
    raise ValueError(f"{O} rows are too many to scan")


def _prefix_at(cols: torch.Tensor, plan: tuple, level: int = 0) -> torch.Tensor:
    """Inclusive prefix sums along the rows of (k, n) ``cols``, read at the
    columns ``plan[level]`` (:func:`_scan_plan`): (k, m), added in an order
    that the shape alone fixes, so a rerun gives the same bits.

    Each row is cut into blocks.  A block's prefix is its product with a
    triangle of ones, one GEMM for all blocks (cuBLAS gives the same bits
    at every run on one GPU model and stream, its "results
    reproducibility"); the blocks' totals behind a zero, their exclusive
    prefixes, are scanned the same way at the next level, and only the
    columns read get their block's offset.  The callers run with TF32 off
    (``@f32``), so the products are fp32 sums.  ``torch.cumsum`` is no such
    scan: PyTorch lists it among the nondeterministic operations on CUDA,
    which scans a row with CUB's decoupled look-back, whose tiles add
    whatever their predecessors have published when they look (two solves
    of the 1DSfM-size problem parted by 3e-3 in the poses)."""
    k, n = cols.shape
    B = _SCAN_BLOCKS[min(level, 1)]
    nb = -(-n // B)
    if nb * B != n:
        cols = torch.nn.functional.pad(cols, (0, nb * B - n))
    within = cols.reshape(k * nb, B) @ _ones_triangle(B, cols.dtype, cols.device)
    got = within.view(k, nb * B).index_select(1, plan[level])
    if nb == 1:
        return got
    B1 = _SCAN_BLOCKS[1]
    totals = torch.nn.functional.pad(within.view(k, nb, B)[:, :-1, -1],
                                     (1, -(-nb // B1) * B1 - nb))
    return got + _prefix_at(totals, plan, level + 1)


def _seg_reduce(vals: torch.Tensor, plan: tuple) -> torch.Tensor:
    """Sorted segment sum via cumsum difference: (O, k) -> (n_seg, k), the
    segments ending where ``plan`` (the layout's :func:`_scan_plan`) says.

    For the per-CG-iteration operator applies only: a segment's absolute
    error scales with the global fp32 prefix, not the segment's, so the
    all-positive block sums use :func:`seg_sum_lm_exact` /
    :func:`seg_sum_cam_exact` instead.  The columns are scanned as the
    rows of a (k, O) tensor (:func:`_prefix_at`): CUDA's scan of a tall
    (O, k) tensor along dim 0 runs each column's 2M rows one after another
    (0.3 s a call at the 1DSfM size)."""
    O = vals.shape[0]
    n = -(-(O + 1) // _SCAN_BLOCKS[0]) * _SCAN_BLOCKS[0]
    e = _prefix_at(torch.nn.functional.pad(vals.T, (1, n - O - 1)), plan)   # (k, n_seg + 1)
    return (e[:, 1:] - e[:, :-1]).T


def seg_reduce_lm(vals: torch.Tensor, lay: ObsLayout) -> torch.Tensor:
    """(O, ...) in by-landmark order -> (L, ...) (prefix difference)."""
    out = _seg_reduce(vals.reshape(vals.shape[0], -1), lay.scan_lm)
    return out.reshape((out.shape[0],) + vals.shape[1:])


def seg_reduce_cam(vals: torch.Tensor, lay: ObsLayout) -> torch.Tensor:
    """(O, ...) in by-landmark order -> (C, ...) (permutes internally)."""
    out = _seg_reduce(vals.reshape(vals.shape[0], -1)[lay.perm_to_cam], lay.scan_cam)
    return out.reshape((out.shape[0],) + vals.shape[1:])


def _exact(vals: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Exact sum of each sorted segment of (O, ...) rows, the segments
    ending at ``ends``: the rows of a segment are added in order."""
    lengths = torch.diff(ends, prepend=ends.new_zeros(1))
    return torch.segment_reduce(vals, "sum", lengths=lengths, axis=0, unsafe=True)


def seg_sum_lm_exact(vals: torch.Tensor, lay: ObsLayout) -> torch.Tensor:
    """Exact (per-segment accumulated) landmark segment sum of (O, ...)
    rows in by-landmark order -> (L, ...)."""
    return _exact(vals, lay.ends_lm)


def seg_sum_cam_exact(vals: torch.Tensor, lay: ObsLayout) -> torch.Tensor:
    """Exact camera segment sum (permutes into by-camera order)."""
    return _exact(vals[lay.perm_to_cam], lay.ends_cam)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Row-wise M v for (N, i, j) and (N, j) -> (N, i).  A broadcast
    product and a sum: ``einsum`` sends it to a batched cuBLAS GEMV,
    which at N = 2M rows splits into 32 launches and takes ~1.4 ms a call
    on an H100, ~10x the bytes' time."""
    return (M * v[:, None, :]).sum(-1)


def _mtv(M: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Row-wise M^T u for (N, i, j) and (N, i) -> (N, j) (see :func:`_mv`)."""
    return (M * u[:, :, None]).sum(-2)


def _linearize(problem: BAProblem, huber_delta: float):
    """Whitened Jacobians + residuals: (O, 2, 6), (O, 2, 3), (O, 2)."""
    r, w, p, _ = residuals_and_weights(problem, huber_delta)
    J_c, J_l = _jacobians(problem, p)
    sw = torch.sqrt(w)[..., None]
    return J_c * sw[..., None], J_l * sw[..., None], r * sw


def _schur_pcg_step(problem: BAProblem, lay: ObsLayout, lam: torch.Tensor,
                    config: BAConfig, reduce_fn=lambda x: x):
    """One damped GN solve via matrix-free Schur PCG.

    ``problem``'s observation arrays must already be in ``lay``'s
    by-landmark order.  ``reduce_fn`` is applied to every camera-space
    partial sum: the identity on one device, an all-reduce over the
    devices of a landmark-sharded solver.  Returns (dxi (C, 6), dX (L, 3))."""
    cam, lm = problem.obs_cam.long(), problem.obs_lm.long()

    Jc, Jl, r_w = _linearize(problem, config.huber_delta)

    # Block-diagonal terms (materialised: O(C + L), small).
    eye6 = torch.eye(6, dtype=Jc.dtype, device=Jc.device)
    eye3 = torch.eye(3, dtype=Jc.dtype, device=Jc.device)
    Hcc = reduce_fn(
        seg_sum_cam_exact(torch.einsum("oij,oik->ojk", Jc, Jc), lay)
    ) + (lam + 1e-8) * eye6
    Hll = seg_sum_lm_exact(torch.einsum("oij,oik->ojk", Jl, Jl), lay) \
        + (lam + 1e-8) * eye3
    Hll_inv = inv3x3(Hll)
    b_c = -reduce_fn(seg_sum_cam_exact(_mtv(Jc, r_w), lay))
    b_l = -seg_sum_lm_exact(_mtv(Jl, r_w), lay)

    free = (~problem.pose_fixed).to(Jc.dtype)[:, None]      # (C, 1)

    def w_t_apply(v):
        """W^T v: camera-space (C, 6) -> landmark-space (L, 3)."""
        return seg_reduce_lm(_mtv(Jl, _mv(Jc, v[cam])), lay)

    def w_apply(z):
        """W z (local shard): landmark-space (L, 3) -> camera (C, 6)."""
        return seg_reduce_cam(_mtv(Jc, _mv(Jl, z[lm])), lay)

    def S_apply(v):
        v = v * free
        Hv = torch.einsum("cij,cj->ci", Hcc, v)
        y = _mv(Hll_inv, w_t_apply(v))
        # In a distributed solver this is THE per-iteration collective:
        # (C, 6) floats over the devices.
        out = (Hv - reduce_fn(w_apply(y))) * free
        # Fixed poses act as identity rows (keeps S positive definite).
        return out + v * (1.0 - free)

    # rhs = b_c - W H_ll^-1 b_l, gauge rows zeroed.
    rhs = (b_c - reduce_fn(w_apply(_mv(Hll_inv, b_l)))) * free

    # Exact block-Jacobi of S (one obs per (cam, lm) pair in BA):
    # G_o = A_o Hll_inv[lm_o] A_o^T with A_o = J_c^T J_l.
    A = torch.einsum("oic,oil->ocl", Jc, Jl)                # (O, 6, 3)
    G = (A @ Hll_inv[lm]) @ A.transpose(1, 2)               # (O, 6, 6)
    corr = reduce_fn(seg_sum_cam_exact(G, lay))
    P = torch.where(problem.pose_fixed[:, None, None], eye6, Hcc - corr)
    # Damped blocks are SPD; a plain inverse is fine at 6x6 (``inv_ex``
    # does not check, so it does not wait on the host).
    P_inv = torch.linalg.inv_ex(P + 1e-6 * eye6).inverse

    def precond(v):
        return torch.einsum("cij,cj->ci", P_inv, v)

    # --- PCG with a branchless convergence freeze ---
    rhs_norm = torch.sqrt((rhs * rhs).sum())
    tol = config.cg_tol * torch.clamp(rhs_norm, min=1e-30)
    x = torch.zeros_like(rhs)
    rr = rhs
    p = precond(rr)
    rz = (rr * p).sum()
    active = rhs_norm > 0
    for _ in range(config.cg_iterations):
        Ap = S_apply(p)
        denom = (p * Ap).sum()
        alpha = rz / torch.where(torch.abs(denom) > 1e-30, denom, 1.0)
        x_n = x + alpha * p
        r_n = rr - alpha * Ap
        z_n = precond(r_n)
        rz_n = (r_n * z_n).sum()
        beta = rz_n / torch.where(torch.abs(rz) > 1e-30, rz, 1.0)
        p_n = z_n + beta * p
        keep = active & (torch.sqrt((r_n * r_n).sum()) > tol)
        x = torch.where(active, x_n, x)
        rr = torch.where(active, r_n, rr)
        p = torch.where(active, p_n, p)
        rz = torch.where(active, rz_n, rz)
        active = keep

    # Landmark back-substitution: dX = H_ll^-1 (b_l - W^T dxi).
    dX = _mv(Hll_inv, b_l - w_t_apply(x * free))
    return x * free, dX


@f32
def bundle_adjust_cg(problem: BAProblem, config: BAConfig = BAConfig(),
                     device=None) -> tuple[BAProblem, BAStats]:
    """LM bundle adjustment with matrix-free Schur PCG camera solves.

    The same interface as ``bundle_adjust``; scales to global problems
    (memory O(O + C + L), never O(C L)).  Runs on ``device`` (CUDA by
    default), to which the problem's fields are moved."""
    problem = state_to(problem, resolve_device(device))
    init_cost = ba_cost(problem, config.huber_delta)

    # Re-order observations once (invalid rows keep w=0 and contribute
    # zeros to every reduction, so they can sit anywhere in the order).
    C = problem.poses.shape[0]
    L = problem.landmarks.shape[0]
    lay = build_obs_layout(problem.obs_cam, problem.obs_lm, C, L)
    o = lay.order_lm
    sorted_problem = problem._replace(
        obs_uv=problem.obs_uv[o],
        obs_cam=lay.cam_sorted,
        obs_lm=lay.lm_sorted,
        obs_valid=problem.obs_valid[o],
    )
    prob, stats = lm_loop(sorted_problem, init_cost, config,
                          lambda prob, lam: _schur_pcg_step(prob, lay, lam, config))
    return problem._replace(poses=prob.poses, landmarks=prob.landmarks), stats
