"""SLAM front end (``slam/frontend.py`` of the JAX package): the two-view
estimate between keyframes (``TwoViewResult`` to ``two_view_from_matches``)
and the per-frame tracking step built on it (``SlamStepResult`` to
``triangulate_in_world``).

Matching (K1 forward, and backward for the mutual check), then both
E- and H-RANSAC on calibration-normalised correspondences, model selection
by truncated transfer score, cheirality-voted pose recovery, a Gauss-Newton
polish of the essential branch and triangulation.  ``slam_step`` adds the
monocular scale, the pose composition and the triangulation at world
poses; ``slam_chunk`` runs it over a batch of frames with the keyframe
carry chosen on the device.  Everything stays on the device: no call waits
on the host.

Under a profiler the stages are ``utils.profiling`` regions: ``nm.slam.chunk``
holds one ``nm.slam.frame`` a frame, and that holds the frame's
``nm.slam.frame.{match,ransac_e,ransac_h,select,scale_tri,carry}``;
``select`` holds ``select.pose_e`` (twice: before and after the polish),
``select.refine`` (the Gauss-Newton polish) and ``select.pose_h``.

The RANSAC draws: the JAX package runs E-RANSAC with ``key`` and
H-RANSAC with ``fold_in(key, 1)``, or both from ``jax.random.key(seed)``
(the same draw) when ``key`` is None, which is what its ``slam_step``
does on every frame.  A ``torch.Generator`` cannot reproduce
``jax.random``, so here the caller may pass the two draws as
``scores_e`` / ``scores_h`` ((iterations, N) Gumbel noise each), or to
``slam_step`` / ``slam_chunk`` as one ``scores = (scores_e, scores_h)``
pair; a draw not given comes from one ``torch.Generator`` seeded with
``ransac_config.seed``, shared by both models as in the JAX package
(``slam_chunk`` draws it once for all its frames).
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
from ..sfm.se3 import hat, se3_apply, se3_compose
from ..sfm.triangulation import _det3, depths, recover_pose, triangulate_dlt
from ..sfm.two_view_refine import refine_relative_pose
from ..sift import match_pair
from ..utils.precision import device_constant, f32, resolve_device
from ..utils.profiling import annotate


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
    with annotate("nm.slam.frame.match"):
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
    with annotate("nm.slam.frame.ransac_e"):
        res_e = ransac(srcn, dstn, mask, cfg, model="essential", scores=scores_e, device=dev)
    with annotate("nm.slam.frame.ransac_h"):
        res_h = ransac(srcn, dstn, mask, cfg, model="homography", scores=scores_h, device=dev)
    with annotate("nm.slam.frame.select"):
        return _select_model(srcn, dstn, mask, m, res_e, res_h, cfg.inlier_threshold, dev)


def _select_model(srcn, dstn, mask, m, res_e, res_h, T_thr, dev) -> TwoViewResult:
    """The E/H choice and the chosen model's pose, inliers and points."""
    # Model selection by truncated symmetric-transfer-error score (the
    # ORB-SLAM heuristic), not inlier count: each masked correspondence
    # contributes max(0, T - err) per direction, and H wins when it holds
    # > 45% of the combined score.
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
    with annotate("nm.slam.frame.select.pose_e"):
        rec_e = recover_pose(res_e.transform, srcn, dstn, res_e.inliers)
    with annotate("nm.slam.frame.select.refine"):
        R_e, t_e, _ = refine_relative_pose(rec_e.R, rec_e.t, srcn, dstn,
                                           res_e.inliers.to(torch.float32))
        E_gn = hat(t_e) @ R_e
        inl_gn = (sampson_sq_error(E_gn, srcn, dstn) < T_thr) & mask
        keep_gn = inl_gn.sum() >= res_e.inliers.sum()
        E_e = torch.where(keep_gn, E_gn, res_e.transform)
        inl_e = torch.where(keep_gn, inl_gn, res_e.inliers)
    with annotate("nm.slam.frame.select.pose_e"):
        rec_e = recover_pose(E_e, srcn, dstn, inl_e)

    # Pose from the homography branch (Faugeras decomposition + cheirality).
    with annotate("nm.slam.frame.select.pose_h"):
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


class SlamStepResult(NamedTuple):
    """Everything the host bookkeeping needs from one SLAM frame, fetched
    by the caller in one batch."""

    indices: torch.Tensor       # (N,) match indices into the new frame
    inliers: torch.Tensor       # (N,) bool
    num_inliers: torch.Tensor   # () int32
    success: torch.Tensor       # () bool
    scale: torch.Tensor         # () float32 resolved monocular scale
    pose: torch.Tensor          # (3, 4) world->cam pose of the new frame
    points_w: torch.Tensor      # (N, 3) world points (A-slot aligned)
    points_valid: torch.Tensor  # (N,) bool (mask & cheirality in both views)


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of ``values[mask]`` (numpy convention: mean of the two middle
    elements for even counts), as a () tensor with no host read.  Returns
    an arbitrary value when the mask is empty: guard at the call site."""
    k = mask.sum(dtype=torch.int64).reshape(1)
    s = torch.sort(torch.where(mask, values, torch.full_like(values, float("inf")))).values
    lo = s.index_select(0, torch.clamp(torch.div(k - 1, 2, rounding_mode="floor"), min=0))
    hi = s.index_select(0, torch.clamp(torch.div(k, 2, rounding_mode="floor"), min=0))
    return (0.5 * (lo + hi))[0]


def _draw_pair(scores, ransac_config: RansacConfig, n: int, dev):
    """The (scores_e, scores_h) pair on ``dev``: ``scores`` as given, or
    one draw from ``ransac_config.seed`` for both models."""
    if scores is None:
        drawn = _gumbel_scores(ransac_config.iterations, n, ransac_config.seed, dev)
        return drawn, drawn
    return tuple(device_constant(a, dev, torch.float32) for a in scores)


def slam_step(
    last_feats: Features,
    feats: Features,
    last_pose: torch.Tensor,
    last_world: torch.Tensor,
    has_track: torch.Tensor,
    intrinsics: tuple[float, float, float, float],
    ransac_config: RansacConfig,
    min_scale_obs: int = 5,
    scores=None,
    device=None,
) -> SlamStepResult:
    """One SLAM frame on ``device`` (CUDA by default): the two-view
    estimate against the last keyframe, the monocular scale from
    re-observed landmarks, the pose composition and the triangulation of
    the matches at the new world pose.

    ``last_world``/``has_track`` are the stored landmark positions (N, 3)
    and their liveness (N,) at the last keyframe's feature slots.  Scale:
    the median over re-observed landmarks of (stored depth in the last
    camera) / (unit-baseline triangulated depth), or 1 when fewer than
    ``min_scale_obs`` ratios survive.  ``scores``: the (scores_e,
    scores_h) RANSAC draws (see the module docstring)."""
    dev = resolve_device(device)
    scores_e, scores_h = (None, None) if scores is None else scores
    tv = estimate_two_view(last_feats, feats, intrinsics, ransac_config,
                           scores_e=scores_e, scores_h=scores_h, device=dev)
    with annotate("nm.slam.frame.scale_tri"):
        last_pose = device_constant(last_pose, dev, torch.float32)
        last_world = device_constant(last_world, dev, torch.float32)
        has_track = device_constant(has_track, dev, torch.bool)

        d_world = se3_apply(last_pose, last_world)[:, 2]
        d_unit = tv.points[:, 2]
        ok = has_track & tv.point_valid & (d_unit > 1e-3) & (d_world > 1e-3)
        ratios = d_world / torch.clamp(d_unit, min=1e-9)
        scale = torch.where(ok.sum() >= min_scale_obs, masked_median(ratios, ok),
                            torch.ones_like(ratios[0]))

        T_rel = torch.cat([tv.R, (scale * tv.t)[:, None]], dim=-1)
        pose = se3_compose(T_rel, last_pose)
        pts_w, valid_w = triangulate_in_world(last_pose, pose, last_feats, feats,
                                              tv.matches, intrinsics, device=dev)
    return SlamStepResult(
        indices=tv.matches.indices,
        inliers=tv.inliers,
        num_inliers=tv.num_inliers,
        success=tv.success,
        scale=scale,
        pose=pose,
        points_w=pts_w,
        points_valid=valid_w,
    )


def slam_chunk(
    last_feats: Features,
    feats_batch: Features,
    last_pose: torch.Tensor,
    last_world: torch.Tensor,
    has_track: torch.Tensor,
    intrinsics: tuple[float, float, float, float],
    ransac_config: RansacConfig,
    min_inliers: int,
    min_scale_obs: int = 5,
    anchor_landmarks: bool = True,
    scores=None,
    device=None,
) -> tuple[SlamStepResult, torch.Tensor]:
    """B sequential SLAM frames (a leading batch axis on every field of
    ``feats_batch``) with no host wait: the JAX package's ``lax.scan`` as a
    loop over the frames.

    The carry is the keyframe state (features, pose, per-slot world points,
    per-slot track liveness).  An accepted frame (success and
    ``min_inliers`` inliers) becomes the new carry keyframe; its world
    context is the scatter of this frame's points into the slots its
    matches landed in (track ids stay host business, applied once per chunk
    from the batched fetch).  With ``anchor_landmarks`` a slot whose
    A-side already carried a landmark keeps that landmark's position.  A
    rejected frame leaves the carry untouched.  Every choice is a
    ``torch.where`` on the device.

    Returns (per-frame ``SlamStepResult`` stacked along a leading axis,
    (B,) bool accepted)."""
    with annotate("nm.slam.chunk"):
        return _slam_chunk(last_feats, feats_batch, last_pose, last_world, has_track,
                           intrinsics, ransac_config, min_inliers, min_scale_obs,
                           anchor_landmarks, scores, resolve_device(device))


def _slam_chunk(last_feats, feats_batch, last_pose, last_world, has_track, intrinsics,
                ransac_config, min_inliers, min_scale_obs, anchor_landmarks, scores, dev):
    carry = (Features(*[device_constant(a, dev) for a in last_feats]),
             device_constant(last_pose, dev, torch.float32),
             device_constant(last_world, dev, torch.float32),
             device_constant(has_track, dev, torch.bool))
    scores = _draw_pair(scores, ransac_config, carry[0].x.shape[-1], dev)
    cap = carry[2].shape[0]
    outs, accepts = [], []
    for i in range(feats_batch.x.shape[0]):
        with annotate("nm.slam.frame"):
            feats_i = Features(*[a[i].to(dev) for a in feats_batch])
            kf_feats, pose, world, has = carry
            out = slam_step(kf_feats, feats_i, pose, world, has, intrinsics,
                            ransac_config, min_scale_obs, scores=scores, device=dev)
            with annotate("nm.slam.frame.carry"):
                accept = out.success & (out.num_inliers >= min_inliers)
                matched = out.inliers & (out.indices >= 0)
                if anchor_landmarks:
                    sel = matched & (has | out.points_valid)
                    carried = torch.where(has[:, None], world, out.points_w)
                else:
                    sel = matched & out.points_valid
                    carried = out.points_w
                # Scatter into a (cap + 1) buffer whose last row takes every
                # unselected slot (the only duplicate target: mutual matches
                # are one-to-one), then drop that row.
                tgt = torch.where(sel, out.indices.long(), cap)
                new_world = torch.zeros((cap + 1, 3), dtype=world.dtype, device=dev)
                new_world = new_world.index_copy_(0, tgt, carried)[:cap]
                new_has = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
                new_has = new_has.index_fill_(0, tgt, True)[:cap]
                cand = (feats_i, out.pose, new_world, new_has)
                carry = (Features(*[torch.where(accept, n, o)
                                    for n, o in zip(cand[0], kf_feats)]),
                         *[torch.where(accept, n, o) for n, o in zip(cand[1:], carry[1:])])
        outs.append(out)
        accepts.append(accept)
    return SlamStepResult(*[torch.stack(f) for f in zip(*outs)]), torch.stack(accepts)


@f32
def triangulate_in_world(
    T_wa: torch.Tensor,
    T_wb: torch.Tensor,
    feats_a: Features,
    feats_b: Features,
    m: MatchResult,
    intrinsics: tuple[float, float, float, float],
    device=None,
):
    """Triangulate matched features given *world* poses of both cameras,
    on ``device`` (CUDA by default).

    Returns ((N, 3) world points, (N,) bool valid) aligned to A's slots."""
    dev = resolve_device(device)
    src, dst, mask = align_points(feats_a.x, feats_a.y, feats_b.x, feats_b.y,
                                  m.indices, feats_a.valid, device=dev)
    srcn = normalize_points(src, intrinsics)
    dstn = normalize_points(dst, intrinsics)
    pts = triangulate_dlt(T_wa, T_wb, srcn, dstn)
    valid = mask & (depths(T_wa, pts) > 1e-3) & (depths(T_wb, pts) > 1e-3)
    return pts, valid
