"""SLAM front end, two-view half: relative pose between two keyframes
(``slam/frontend.py`` of the JAX package, ``TwoViewResult`` to
``two_view_from_matches``).

Matching (K1 forward, and backward for the mutual check), then both
E- and H-RANSAC on calibration-normalised correspondences, model selection
by truncated transfer score, cheirality-voted pose recovery, a Gauss-Newton
polish of the essential branch and triangulation.  Everything stays on
the device: no call waits on the host.

The RANSAC draws: the JAX package runs E-RANSAC with ``key`` and
H-RANSAC with ``fold_in(key, 1)``, or both from ``jax.random.key(seed)``
(the same draw) when ``key`` is None.  A ``torch.Generator`` cannot
reproduce ``jax.random``, so here the caller may pass the two draws as
``scores_e`` / ``scores_h`` ((iterations, N) Gumbel noise each); a draw
not given comes from one ``torch.Generator`` seeded with
``ransac_config.seed``, shared by both models as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..config import RansacConfig
from ..features import Features
from ..geometry.linalg import inv3x3
from ..geometry.ransac import _gumbel_scores, align_points, ransac
from ..geometry.transforms import sampson_sq_error, transfer_sq_error
from ..ops.gradients import div_const
from ..ops.match import MatchResult, mutual_matches
from ..sfm.homography import recover_pose_homography
from ..sfm.se3 import hat
from ..sfm.triangulation import _det3, recover_pose
from ..sfm.two_view_refine import refine_relative_pose
from ..sift import match_pair
from ..utils.precision import f32, resolve_device


class TwoViewResult(NamedTuple):
    """Fixed-shape two-view estimate between frames A and B.

    ``(R, t)`` is the pose of camera B with A as the world frame
    (x_b = R x_a + t, unit-norm t).  ``points`` are triangulated in A's
    frame at that unit scale."""

    matches: MatchResult
    E: torch.Tensor             # (3, 3) essential matrix
    inliers: torch.Tensor       # (N,) bool over A's feature slots
    num_inliers: torch.Tensor   # () int32
    R: torch.Tensor             # (3, 3)
    t: torch.Tensor             # (3,) unit translation
    points: torch.Tensor        # (N, 3) triangulated points in A's frame
    point_valid: torch.Tensor   # (N,) bool (inlier & cheirality)
    success: torch.Tensor       # () bool


def normalize_points(pts: torch.Tensor, intrinsics: Sequence[float]) -> torch.Tensor:
    """Pixel -> normalised camera coords with (fx, fy, cx, cy) numbers."""
    fx, fy, cx, cy = (float(v) for v in intrinsics)
    return torch.stack([div_const(pts[..., 0] - cx, fx),
                        div_const(pts[..., 1] - cy, fy)], dim=-1)


def estimate_two_view(
    feats_a: Features,
    feats_b: Features,
    intrinsics: tuple[float, float, float, float],
    ransac_config: RansacConfig = RansacConfig(inlier_threshold=4.0),
    ambiguity: float = 0.7,
    mutual: bool = True,
    scores_e=None,
    scores_h=None,
    device=None,
) -> TwoViewResult:
    """Match two feature sets and estimate relative pose via E-RANSAC, on
    ``device`` (CUDA by default).

    ``ransac_config.inlier_threshold`` is a squared *pixel* threshold; it is
    rescaled to the normalised-coordinate Sampson error.  ``mutual=True``
    cross-checks matches in both directions before RANSAC (two K1 launches
    on the card).  ``scores_e`` / ``scores_h``: see the module docstring."""
    dev = resolve_device(device)
    m = match_pair(feats_a, feats_b, ambiguity=ambiguity, device=dev)
    if mutual:
        bwd = match_pair(feats_b, feats_a, ambiguity=ambiguity, device=dev)
        m = m._replace(indices=mutual_matches(m, bwd))
    return two_view_from_matches(feats_a, feats_b, m, intrinsics, ransac_config,
                                 scores_e=scores_e, scores_h=scores_h, device=dev)


@f32
def two_view_from_matches(
    feats_a: Features,
    feats_b: Features,
    m: MatchResult,
    intrinsics: tuple[float, float, float, float],
    ransac_config: RansacConfig = RansacConfig(inlier_threshold=4.0),
    scores_e=None,
    scores_h=None,
    device=None,
) -> TwoViewResult:
    """Two-view pose estimate from precomputed match indices: the geometry
    half of :func:`estimate_two_view`, on ``device`` (CUDA by default)."""
    dev = resolve_device(device)
    src, dst, mask = align_points(feats_a.x, feats_a.y, feats_b.x, feats_b.y,
                                  m.indices, feats_a.valid, device=dev)
    srcn = normalize_points(src, intrinsics)
    dstn = normalize_points(dst, intrinsics)
    f_mean = 0.5 * (float(intrinsics[0]) + float(intrinsics[1]))
    cfg = RansacConfig(
        iterations=ransac_config.iterations,
        inlier_threshold=ransac_config.inlier_threshold / (f_mean * f_mean),
        seed=ransac_config.seed,
    )
    if scores_e is None or scores_h is None:
        drawn = _gumbel_scores(cfg.iterations, srcn.shape[0], cfg.seed, dev)
        scores_e = drawn if scores_e is None else scores_e
        scores_h = drawn if scores_h is None else scores_h

    # Run BOTH models (ORB-SLAM-style H/E selection): quasi-planar scenes
    # make E unrecoverable (2-D null space in the 8-point system) but are
    # exactly a homography; general scenes prefer E.
    res_e = ransac(srcn, dstn, mask, cfg, model="essential", scores=scores_e, device=dev)
    res_h = ransac(srcn, dstn, mask, cfg, model="homography", scores=scores_h, device=dev)

    # Model selection by truncated symmetric-transfer-error score (the
    # ORB-SLAM heuristic), not inlier count: each masked correspondence
    # contributes max(0, T - err) per direction, and H wins when it holds
    # > 45% of the combined score.
    T_thr = cfg.inlier_threshold
    H = res_h.transform
    # Adjugate inverse with a nudged singular H: H comes from a masked
    # RANSAC and can be arbitrary when res_h.success is False.
    eye3 = torch.eye(3, dtype=H.dtype, device=dev)
    nudge = torch.where(torch.abs(_det3(H)) < 1e-12, 1e-6, torch.zeros_like(H[0, 0]))
    H_inv = inv3x3(H + nudge * eye3)
    err_h = transfer_sq_error(H, srcn, dstn) + transfer_sq_error(H_inv, dstn, srcn)
    # Sampson error is the symmetric first-order epipolar residual; double
    # its truncated score so one correspondence weighs the same 2T ceiling
    # in both branches.
    err_e_sel = sampson_sq_error(res_e.transform, srcn, dstn)
    s_h = torch.where(mask, torch.clamp(2.0 * T_thr - err_h, min=0.0), 0.0).sum()
    s_e = torch.where(mask, 2.0 * torch.clamp(T_thr - err_e_sel, min=0.0), 0.0).sum()
    use_h = res_h.success & ((~res_e.success) | (s_h > 0.45 * (s_h + s_e)))

    # Pose from the essential branch, with GN Sampson polish on inliers.
    rec_e = recover_pose(res_e.transform, srcn, dstn, res_e.inliers)
    R_e, t_e, _ = refine_relative_pose(rec_e.R, rec_e.t, srcn, dstn,
                                       res_e.inliers.to(torch.float32))
    E_gn = hat(t_e) @ R_e
    inl_gn = (sampson_sq_error(E_gn, srcn, dstn) < cfg.inlier_threshold) & mask
    keep_gn = inl_gn.sum() >= res_e.inliers.sum()
    E_e = torch.where(keep_gn, E_gn, res_e.transform)
    inl_e = torch.where(keep_gn, inl_gn, res_e.inliers)
    rec_e = recover_pose(E_e, srcn, dstn, inl_e)

    # Pose from the homography branch (Faugeras decomposition + cheirality).
    rec_h = recover_pose_homography(res_h.transform, srcn, dstn, res_h.inliers)
    E_h = hat(rec_h.t) @ rec_h.R

    def pick(h, e):
        return torch.where(use_h, h, e)

    inliers = pick(res_h.inliers, inl_e)
    num_good = pick(rec_h.num_good, rec_e.num_good)
    num = inliers.sum(dtype=torch.int32)
    success = (res_e.success | res_h.success) & (num_good >= num // 2) & (num >= 8)
    return TwoViewResult(
        matches=m,
        E=pick(E_h, E_e),
        inliers=inliers,
        num_inliers=num,
        R=pick(rec_h.R, rec_e.R),
        t=pick(rec_h.t, rec_e.t),
        points=pick(rec_h.points, rec_e.points),
        point_valid=pick(rec_h.cheirality, rec_e.cheirality) & inliers,
        success=success,
    )
