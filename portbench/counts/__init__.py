"""Roofline counts: the least time the chip could take for a kernel's work.

Copied from ``chip_smoke.py`` (``bound``, ``bf16_bound``, ``window_work``,
the K2/K3 operation counts and the data-sheet peaks) and ``chip_smoke.py``'s
K1 3xTF32 convention, at commit def8df72c5c264abd9e3aa10eba50d4d66e57296.
``window_work`` now reads the benchmark's frozen reference SIFT instead of
the program's modules, and K1's work is counted from the sweep's shapes.

Peaks are NVIDIA's H100 SXM data sheet (dense, no sparsity), which assume
the card's full 700 W power limit; a run prints the card's limit beside
them.
"""

from __future__ import annotations

import math

import torch

PEAK_BYTES_PER_S = 3.35e12     # HBM3
PEAK_FP32_PER_S = 67e12        # fp32 outside the tensor cores
PEAK_TF32_PER_S = 495e12       # tensor cores, dense TF32
PEAK_BF16_PER_S = 989e12       # tensor cores, dense bf16
# fp32 operations that a window pixel which adds to the result needs (exp,
# division, floor and the add into a bin count one each).  K3: offsets 2,
# rotation and scaling to bin units 8, window weight 6 (squares and sum 3,
# scale, exp, times magnitude), angle wrap and scaling 4, and the nonzero
# tents of the x, y and theta axes from one floor and one fraction, 3 each;
# then 2 for each (ybin, xbin) pair with nonzero tents (tent product, times
# the weight) and 2 for each of its nonzero theta bins (times the tent,
# add).
K3_OPS_PER_PIXEL = 29
K3_OPS_PER_PAIR = 2
K3_OPS_PER_BIN = 2


def bound_s(nbytes: float, ops: float, ops_per_s: float = PEAK_FP32_PER_S):
    """Least seconds for the work, the larger of bytes at the memory rate
    and operations at their rate, and which of the two it is."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sweep_bound_s(frames: int, slots: int, dim: int, precision: str):
    """K1's least seconds for one all-pairs sweep of ``frames`` x ``slots``
    descriptors of ``dim`` values: 2 (K N)^2 D operations, at the bf16 rate
    in bf16 mode and as three TF32 products at the TF32 rate in fp32 mode;
    bytes: each operand row and its two norms read once, each launch's
    three outputs a row (min1, idx1, min2) written once."""
    rows = frames * slots
    ops = 2.0 * rows * rows * dim
    elem = 2 if precision == "bf16" else 4
    nbytes = rows * dim * elem + 2 * rows * 4 + frames * rows * 12
    if precision == "bf16":
        return bound_s(nbytes, ops, PEAK_BF16_PER_S)
    return bound_s(nbytes, 3 * ops, PEAK_TF32_PER_S)


def window_work(planes, cfg, kp, image, valid, angle0, step=256):
    """The work K3 must do on these keypoints: the masks of the planes'
    pixels whose magnitude and angle must be read, the fp32 operations of
    the needed pixels with nonzero magnitude (the ones that add), and the
    count of those pixels over keypoints."""
    from ..reference.sift.ops.descriptor import _spatial_tents, _theta_tents
    from ..reference.sift.ops.gradients import TWO_PI, div_const, mod_2pi
    from ..reference.sift.ops.patches import gather_windows, patch_offsets
    from ..reference.sift.pipeline import window_params

    sel = valid.nonzero().squeeze(1)
    x, y, sigma, octave, level = (t[sel] for t in kp)
    xo, yo, so, xi, yi, slab = window_params(planes, x, y, sigma, octave, level, image[sel])
    r = planes.radius
    rw = r
    sbp = 3.0 * so + 1e-7
    w = torch.floor(math.sqrt(2.0) * sbp * 5 / 2.0 + 0.5).clamp(max=float(r))
    a0 = angle0[sel]
    ho = torch.full_like(octave, cfg.height) >> octave
    wo = torch.full_like(octave, cfg.width) >> octave
    fy, fx = patch_offsets(rw, x.device)
    iy, ix = fy.long(), fx.long()
    need_mag = torch.zeros(planes.mag.shape, dtype=torch.bool, device=x.device)
    need_ang = torch.zeros_like(need_mag)
    ops = pixels = 0
    for s in range(0, sel.numel(), step):
        c = slice(s, s + step)

        def e(t):  # per keypoint of the step, broadcast over the window
            return t[c][:, None, None]

        dx = fx + e(xi.float() - xo)
        dy = fy + e(yi.float() - yo)
        rows, cols = e(yi.long()) + iy, e(xi.long()) + ix
        need = ((fx.abs() <= e(w)) & (fy.abs() <= e(w)) & (rows >= 0)
                & (rows < e(ho)) & (cols >= 0) & (cols < e(wo)))
        r0, c0 = yi[c] + (r - rw), xi[c] + (r - rw)
        mag = gather_windows(planes.mag, slab[c], r0, c0, 2 * rw + 1)
        st, ct = e(torch.sin(a0)), e(torch.cos(a0))
        nx = (ct * dx + st * dy) / e(sbp)
        ny = (-st * dx + ct * dy) / e(sbp)
        pairs = (_spatial_tents(nx) > 0).sum(-1) * (_spatial_tents(ny) > 0).sum(-1)
        need &= pairs > 0
        ang = gather_windows(planes.ang, slab[c], r0, c0, 2 * rw + 1)
        nt = div_const(8.0 * mod_2pi(ang - e(a0)), TWO_PI)
        bins = pairs * (_theta_tents(nt) > 0).sum(-1)
        per_px = K3_OPS_PER_PIXEL + K3_OPS_PER_PAIR * pairs + K3_OPS_PER_BIN * bins
        adds = need & (mag != 0)
        ops += int((adds * per_px).sum())
        pixels += int(adds.sum())
        at = (e(slab.long()).expand_as(need), (rows + r).expand_as(need),
              (cols + r).expand_as(need))
        need_mag[tuple(t[need] for t in at)] = True
        need_ang[tuple(t[adds] for t in at)] = True
    return need_mag, need_ang, ops, pixels


def k3_bound_s(work, cfg):
    """K3's least seconds for one batch (``reference.sift.pipeline.K3Work``):
    the needed pixels of both planes, each slot's valid flag read and its
    128 outputs written, and a valid slot's x, y, sigma, octave, level,
    image and angle0 read."""
    need_mag, need_ang, ops, _ = window_work(work.planes, cfg, work.kp, work.image,
                                             work.valid, work.angle0)
    slots = work.valid.numel()
    n_k = int(work.valid.sum())
    nbytes = (4 * int(need_mag.sum()) + 4 * int(need_ang.sum()) + slots
              + 28 * n_k + 128 * 4 * slots)
    return bound_s(nbytes, ops)
