"""RANSAC's two kernels (``kernels/ransac.py``, ``csrc/ransac.cu``) held
against ``geometry.ransac.ransac_plain`` on one problem and one draw: the
comparison that ``chip_smoke.py``'s ransac phase and the card tests share.

Two results agree when they have the same success; their transforms lie
within ``atol`` (a homography: where they send a frame's four corners, in
px; an essential matrix: its entries, up to sign); the inlier flags differ
only where the error under the plain transform lies within 1e-4 tau of
tau, where fp32 rounding may fall either way; and ``num_inliers`` differs
by no more than the flags that differ.
"""

from __future__ import annotations

import numpy as np
import torch

FLAG_EDGE = 1e-4        # flags may differ within this share of tau from tau


def fit_gaps(model, got, want, src, dst, tau, extent):
    """How far RansacResults ``got`` and ``want`` of one problem lie apart:
    ``{"transform_gap", "flag_diffs", "flag_edge", "inlier_gap"}``.  The
    homography's gap is measured at the corners (0, 0) to ``extent`` =
    (x, y) of its frame; ``flag_edge`` is the largest |err - tau| at the
    differing flags (0 where none differ)."""
    from niftymatch_torch.geometry.ransac import _error_fn

    tg, tw = (r.transform.detach().double().cpu().numpy() for r in (got, want))
    if model == "homography":
        x, y = extent
        c = np.array([[0, 0, 1], [x, 0, 1], [0, y, 1], [x, y, 1]], float).T
        pg, pw = tg @ c, tw @ c
        gap = float(np.abs(pg[:2] / pg[2] - pw[:2] / pw[2]).max())
    else:
        gap = float(min(np.abs(tg - tw).max(), np.abs(tg + tw).max()))
    dev = want.transform.device
    err = _error_fn(model)(want.transform, torch.as_tensor(src, device=dev),
                           torch.as_tensor(dst, device=dev)).cpu().numpy()
    differ = (got.inliers != want.inliers).cpu().numpy()
    return {"transform_gap": gap, "flag_diffs": int(differ.sum()),
            "flag_edge": float(np.abs(err[differ] - tau).max()) if differ.any() else 0.0,
            "inlier_gap": abs(int(got.num_inliers) - int(want.num_inliers))}


def check(model, got, want, gaps, tau, atol=1e-3) -> None:
    """Raise AssertionError unless ``got`` and ``want`` agree (the module's
    note) by ``gaps`` = ``fit_gaps(...)``."""
    assert bool(got.success) == bool(want.success), \
        f"ransac {model}: success {bool(got.success)} against {bool(want.success)}"
    assert gaps["transform_gap"] <= atol and gaps["flag_edge"] <= FLAG_EDGE * tau \
        and gaps["inlier_gap"] <= gaps["flag_diffs"], f"ransac {model}: {gaps}"
