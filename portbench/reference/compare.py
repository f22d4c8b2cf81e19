"""The numbers that decide ``correct``: a program's outputs against the
reference's, each number a share or a gap that reads 0 on agreement.

* ``feature_gaps``: keypoints are paired across the two sides as mutual
  nearest neighbours in the same octave within ``POS_TOL`` px.
  ``kp_miss`` is the share of keypoints of either side left unpaired;
  ``desc_miss`` the share of the keypoints paired within ``DESC_TOL`` px in
  the same octave and level whose descriptors differ by more than
  ``DESC_ATOL`` in some value.  (The largest difference itself is no
  steady number: a gradient angle on a bin's edge moves a few samples to
  the next bin on one device and not on another, and one such keypoint in
  thousands reads ~0.2.)
* ``match_miss``: the share of A rows, among those that either side
  matched, whose match on the program's side is not the reference's
  (the B keypoint is compared through the pairing, not by slot).
* ``index_miss`` / ``count_gap``: an all-pairs sweep's indices that differ,
  over the entries that either side matched (or only those the reference
  decides with a margin), and the summed difference of its pair counts over
  the reference's sum.
* ``ate_share``: Sim(3)-aligned RMSE of keyframe centres (Umeyama) over the
  true trajectory's extent, the mean distance of its centres from their
  centroid.
"""

from __future__ import annotations

import numpy as np
import torch

POS_TOL = 1e-3   # px: the front ends are the same float32 operations
DESC_TOL = 0.5   # px: pairs whose descriptors are compared (same octave and level)
DESC_ATOL = 1e-3  # a descriptor differs when one of its values moves by more
FIELDS = ("x", "y", "octave", "level", "valid", "desc")


def _pairing(p, r, tol, same_level=False):
    """Mutual nearest keypoints of one image within ``tol`` px in the same
    octave (and level): (map ref slot -> prog slot or -1, map prog slot ->
    ref slot or -1), both over all slots."""
    pxy = torch.stack([p["x"], p["y"]], -1).to(torch.float64)
    rxy = torch.stack([r["x"], r["y"]], -1).to(torch.float64)
    same = r["valid"][:, None] & p["valid"][None, :] & (r["octave"][:, None] == p["octave"][None, :])
    if same_level:
        same &= r["level"][:, None] == p["level"][None, :]
    d = torch.where(same, torch.cdist(rxy, pxy), torch.full(same.shape, float("inf"),
                                                                 dtype=torch.float64,
                                                                 device=same.device))
    r2p = torch.full(r["valid"].shape, -1, dtype=torch.long, device=d.device)
    p2r = torch.full(p["valid"].shape, -1, dtype=torch.long, device=d.device)
    if d.numel():
        best_p = d.argmin(1)
        best_r = d.argmin(0)
        ok = (best_r[best_p] == torch.arange(d.shape[0], device=d.device)) & \
            (d.gather(1, best_p[:, None])[:, 0] <= tol)
        r2p = torch.where(ok, best_p, r2p)
        p2r[best_p[ok]] = torch.nonzero(ok)[:, 0]
    return r2p, p2r


def _image(f, i):
    return {k: f[k][i] for k in FIELDS}


def feature_gaps(prog: dict, ref: dict):
    """``prog`` and ``ref``: dicts of (B, M) fields (``desc`` (B, M, 128)).
    Returns ({"kp_miss", "desc_miss"}, per-image pairings at ``POS_TOL``).
    ``desc_miss`` is the share of the keypoints paired within ``DESC_TOL``
    in the same octave and level whose descriptors differ by more than
    ``DESC_ATOL`` in some value, so that it reads descriptors of keypoints
    that moved a little too."""
    unpaired = total = differ = near_total = 0
    pairings = []
    for i in range(ref["x"].shape[0]):
        p, r = _image(prog, i), _image(ref, i)
        r2p, p2r = _pairing(p, r, POS_TOL)
        pairings.append((r2p, p2r))
        n_r, n_p = int(r["valid"].sum()), int(p["valid"].sum())
        n_pair = int((r2p >= 0).sum())
        unpaired += (n_r - n_pair) + (n_p - n_pair)
        total += n_r + n_p
        near, _ = _pairing(p, r, DESC_TOL, same_level=True)
        sel = torch.nonzero(near >= 0)[:, 0]
        if sel.numel():
            gap = (p["desc"][near[sel]].double() - r["desc"][sel].double()).abs().amax(-1)
            differ += int((gap > DESC_ATOL).sum())
            near_total += int(sel.numel())
    return {"kp_miss": unpaired / max(total, 1),
            "desc_miss": differ / near_total if near_total else 1.0}, pairings


def match_miss(prog_idx, ref_idx, pair_a, pair_b) -> tuple[int, int]:
    """One pair of images: (rows that differ, rows either side matched).
    ``pair_a``/``pair_b``: the pairings of image A and image B."""
    r2p_a, _ = pair_a
    _, p2r_b = pair_b
    prog_idx, ref_idx = prog_idx.long(), ref_idx.long()
    p = r2p_a
    prog_match = torch.where(p >= 0, prog_idx[p.clamp(min=0)], torch.full_like(p, -1))
    prog_in_ref = torch.where(prog_match >= 0, p2r_b[prog_match.clamp(min=0)],
                              torch.full_like(prog_match, -1))
    # A program match to a B keypoint the reference lacks reads -2.
    prog_in_ref = torch.where((prog_match >= 0) & (prog_in_ref < 0),
                              torch.full_like(prog_in_ref, -2), prog_in_ref)
    lost = (p < 0) & (ref_idx >= 0)
    either = (ref_idx >= 0) | (prog_in_ref != -1) | lost
    differ = either & ((prog_in_ref != ref_idx) | lost)
    # Program rows with no reference counterpart that matched something.
    _, p2r_a = pair_a
    extra = (p2r_a < 0) & (prog_idx >= 0)
    return int(differ.sum() + extra.sum()), int(either.sum() + extra.sum())


def index_miss(prog_idx, ref_idx, sure=None) -> float:
    """Entries of two sweeps' index tables that differ, over the entries
    that either side matched; with ``sure``, only over the entries whose
    answer the reference's precision decides (``match.allpairs_decided``)."""
    pi, ri = prog_idx.long(), ref_idx.long()
    either = (pi >= 0) | (ri >= 0)
    if sure is not None:
        either &= sure
    return int((either & (pi != ri)).sum()) / max(int(either.sum()), 1)


def count_gap(prog_counts, ref_counts) -> float:
    """Summed difference of two sweeps' pair counts over the reference's sum."""
    pc, rc = prog_counts.long(), ref_counts.long()
    return int((pc - rc).abs().sum()) / max(int(rc.sum()), 1)


def umeyama(src: np.ndarray, dst: np.ndarray):
    """(s, R, t) with dst ~ s R src + t (Umeyama 1991), float64."""
    src, dst = np.asarray(src, np.float64), np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    cs, cd = src - mu_s, dst - mu_d
    U, D, Vt = np.linalg.svd(cd.T @ cs / src.shape[0])
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_s = (cs ** 2).sum() / src.shape[0]
    s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-18))
    return s, R, mu_d - s * R @ mu_s


def centres(poses: np.ndarray) -> np.ndarray:
    """(K, 3, 4) world->camera poses -> (K, 3) camera centres."""
    poses = np.asarray(poses, np.float64)
    return -np.einsum("kji,kj->ki", poses[:, :, :3], poses[:, :, 3])


def ate_share(est_centres: np.ndarray, true_centres: np.ndarray) -> float:
    gt = np.asarray(true_centres, np.float64)
    est = np.asarray(est_centres, np.float64)
    if len(est) < 3 or not np.isfinite(est).all():
        return float("inf")
    s, R, t = umeyama(est, gt)
    err = (s * (R @ est.T)).T + t - gt
    ate = float(np.sqrt((err ** 2).sum(1).mean()))
    extent = float(np.linalg.norm(gt - gt.mean(0), axis=1).mean())
    return ate / extent
