# Frozen copy of niftymatch_torch/ops/keypoints.py at commit def8df72c5c264abd9e3aa10eba50d4d66e57296, unchanged below this
# header: part of the benchmark's plain reference, imported by nothing of the program.
"""DoG extrema, sub-pixel refinement and per-level top-k
(``ops/keypoints.py`` of the JAX package; ``keypoint.cu:19-180`` of the
reference).

Every function takes optional leading batch axes before the level axis.
Differences from the JAX file, none of which changes a result:

* The per-level top-k is always exact (a stable sort, lower index first
  among ties, as ``jax.lax.top_k`` orders them).  The JAX package swaps in
  ``approx_max_k`` on a TPU only; its CPU path, which the tests compare
  against, is exact.
* ``_shift2d`` wraps like ``jnp.roll``; the wrap touches only the border
  ring, which the extremum test masks out.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SiftConfig
from ..features import topk_desc_stable


class Keypoints(NamedTuple):
    x: torch.Tensor         # (..., L, K) refined x in input-image coords
    y: torch.Tensor
    sigma: torch.Tensor     # absolute scale
    level: torch.Tensor     # int32 DoG level within the octave
    response: torch.Tensor  # |interpolated DoG value|
    valid: torch.Tensor     # bool


def _shift2d(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``result[..., y, x] = a[..., y+dy, x+dx]`` with wrap-around."""
    return torch.roll(a, shifts=(-dy, -dx), dims=(-2, -1))


_NEIGHBORS_8 = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)]
_NEIGHBORS_9 = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def _triples(dog: torch.Tensor):
    """(down, cur, up) DoG slices centred on keypoint levels 0..L-1."""
    return dog[..., :-2, :, :], dog[..., 1:-1, :, :], dog[..., 2:, :, :]


def extrema_mask(dog: torch.Tensor, peak_threshold: float) -> torch.Tensor:
    """Strict 26-neighbour extremum mask, (..., num_dogs, H, W) ->
    bool (..., num_dogs - 2, H, W), interior pixels only."""
    down, cur, up = _triples(dog)
    c = cur
    is_max = torch.ones(c.shape, dtype=torch.bool, device=c.device)
    is_min = torch.ones(c.shape, dtype=torch.bool, device=c.device)
    for dy, dx in _NEIGHBORS_8:
        n = _shift2d(cur, dy, dx)
        is_max &= c > n
        is_min &= c < n
    for sl in (down, up):
        for dy, dx in _NEIGHBORS_9:
            n = _shift2d(sl, dy, dx)
            is_max &= c > n
            is_min &= c < n
    thr = 0.8 * peak_threshold
    mask = ((c >= thr) & is_max) | ((c <= thr) & is_min)
    h, w = c.shape[-2:]
    interior = torch.zeros((h, w), dtype=torch.bool, device=c.device)
    interior[1:-1, 1:-1] = True
    return mask & interior


def refine_keypoints(dog: torch.Tensor, mask: torch.Tensor, octave: int,
                     config: SiftConfig):
    """Dense branchless sub-pixel refinement: per-pixel x, y, sigma,
    |response| and acceptance mask, each (..., L, H, W)."""
    down, cur, up = _triples(dog)
    c = cur
    sh = _shift2d

    fx = 0.5 * (sh(cur, 0, 1) - sh(cur, 0, -1))
    fy = 0.5 * (sh(cur, 1, 0) - sh(cur, -1, 0))
    fs = 0.5 * (up - down)

    fxx = sh(cur, 0, 1) + sh(cur, 0, -1) - 2.0 * c
    fyy = sh(cur, 1, 0) + sh(cur, -1, 0) - 2.0 * c
    fss = up + down - 2.0 * c
    fxy = 0.25 * (sh(cur, 1, 1) + sh(cur, -1, -1) - sh(cur, 1, -1) - sh(cur, -1, 1))
    fxs = 0.25 * (sh(up, 0, 1) + sh(down, 0, -1) - sh(up, 0, -1) - sh(down, 0, 1))
    fys = 0.25 * (sh(up, 1, 0) + sh(down, -1, 0) - sh(up, -1, 0) - sh(down, 1, 0))

    # Cramer's rule on [fxx fxy fxs; fxy fyy fys; fxs fys fss] d = -g.
    det = (
        fxx * (fyy * fss - fys * fys)
        - fxy * (fxy * fss - fys * fxs)
        + fxs * (fxy * fys - fyy * fxs)
    )
    solvable = torch.abs(det) > 1e-30
    safe_det = torch.where(solvable, det, torch.ones_like(det))
    bx, by, bs = -fx, -fy, -fs
    dx = (
        bx * (fyy * fss - fys * fys)
        - fxy * (by * fss - fys * bs)
        + fxs * (by * fys - fyy * bs)
    ) / safe_det
    dy = (
        fxx * (by * fss - fys * bs)
        - bx * (fxy * fss - fys * fxs)
        + fxs * (fxy * bs - by * fxs)
    ) / safe_det
    ds = (
        fxx * (fyy * bs - by * fys)
        - fxy * (fxy * bs - by * fxs)
        + bx * (fxy * fys - fyy * fxs)
    ) / safe_det

    v = c + 0.5 * (dx * fx + dy * fy + ds * fs)

    det2 = fxx * fyy - fxy * fxy
    edge_score = (fxx + fyy) * (fxx + fyy) / torch.where(
        det2 == 0.0, torch.full_like(det2, 1e-30), det2
    )
    e = config.edge_threshold
    edge_ok = edge_score < (e + 1.0) * (e + 1.0) / e
    if not config.compat.accept_negative_edge_score:
        edge_ok &= det2 > 0.0

    accept = (
        mask
        & solvable
        & (torch.abs(v) > config.peak_threshold)
        & edge_ok
        & (torch.abs(dx) < 1.0)
        & (torch.abs(dy) < 1.0)
        & (torch.abs(ds) < 1.0)
    )

    xper = float(2.0 ** octave)
    L, h, w = c.shape[-3:]
    kw = dict(dtype=torch.float32, device=c.device)
    gx = torch.arange(w, **kw).view(1, 1, w)
    gy = torch.arange(h, **kw).view(1, h, 1)
    lvl = torch.arange(L, **kw).view(L, 1, 1)

    x_ref = (gx + dx) * xper
    y_ref = (gy + dy) * xper
    sigma = config.sigma_0 * torch.exp2((lvl + ds) / config.num_dog_levels) * xper
    return x_ref, y_ref, sigma, torch.abs(v), accept


def detect_keypoints(dog: torch.Tensor, octave: int, config: SiftConfig,
                     mask_image: torch.Tensor | None = None) -> Keypoints:
    """Detect + refine + keep the top ``max_keypoints_per_level`` of each
    level by |response|: ``Keypoints`` of shape (..., num_dog_levels, K).

    ``mask_image`` (..., H, W) keeps pixels whose input-image position has
    mask >= 1 (``siftfunctions.cu:65-98``)."""
    mask = extrema_mask(dog, config.peak_threshold)
    if mask_image is not None:
        xper = 2 ** octave
        m = mask_image[..., ::xper, ::xper][..., : dog.shape[-2], : dog.shape[-1]]
        mask = mask & (m >= 1.0).unsqueeze(-3)

    x, y, sigma, resp, valid = refine_keypoints(dog, mask, octave, config)

    k = config.max_keypoints_per_level
    lead = x.shape[:-2]                     # (..., L)
    flat_scores = torch.where(valid, resp, torch.full_like(resp, float("-inf")))
    flat_scores = flat_scores.reshape(lead + (-1,))
    n = flat_scores.shape[-1]
    if n < k:
        flat_scores = torch.nn.functional.pad(flat_scores, (0, k - n),
                                              value=float("-inf"))
    top_scores, top_idx = topk_desc_stable(flat_scores, k)

    def take(a):
        flat = a.reshape(lead + (-1,))
        if n < k:
            flat = torch.nn.functional.pad(flat, (0, k - n))
        return torch.gather(flat, -1, top_idx)

    sel_valid = torch.isfinite(top_scores)
    L = lead[-1]
    level = torch.arange(L, dtype=torch.int32, device=x.device).view(L, 1)
    return Keypoints(
        x=take(x),
        y=take(y),
        sigma=take(sigma),
        level=level.expand(lead + (k,)),
        response=torch.where(sel_valid, top_scores, torch.zeros_like(top_scores)),
        valid=sel_valid,
    )
