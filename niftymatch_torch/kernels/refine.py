"""The two-view Gauss-Newton polish in one launch (``csrc/refine.cu``).

The kernel runs all of ``sfm.two_view_refine.refine_relative_pose``'s
steps, reductions and accept/reject decisions in one CTA: the algorithm of
the plain version there (which CPU tensors take), with an analytic
Jacobian in place of ``jacfwd`` and its sums in another order.  The
wrapper allocates the outputs, launches on the current stream and neither
reads the device nor synchronises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "nm_refine_relative_pose": [_P, _P, _P, _P, _P, _I, _I, ctypes.c_float,
                                _P, _P, _P, _P],
}


def refine_relative_pose(R0, t0, pts_a, pts_b, weights, iterations: int = 10,
                         damping: float = 1e-6):
    """(R, t, cost) after ``iterations`` damped Gauss-Newton steps from
    (R0, t0) on the (N, 2) correspondences weighted by the (N,) weights;
    CUDA tensors only."""
    n = pts_a.shape[0]
    args = [t.to(torch.float32).contiguous() for t in (R0, t0, pts_a, pts_b, weights)]
    for name, t, shape in zip(("R0", "t0", "pts_a", "pts_b", "weights"), args,
                              ((3, 3), (3,), (n, 2), (n, 2), (n,))):
        _build.require_cuda(name, t, torch.float32, shape)
        if t.device != args[0].device:
            raise ValueError(f"{name}: on {t.device}, R0 on {args[0].device}")
    if iterations < 0:
        raise ValueError(f"iterations must be >= 0, got {iterations}")
    kw = dict(dtype=torch.float32, device=args[0].device)
    R, t, cost = torch.empty((3, 3), **kw), torch.empty((3,), **kw), torch.empty((), **kw)
    lib = _build.load("refine", _SIGNATURES)
    rc = lib.nm_refine_relative_pose(*[a.data_ptr() for a in args], n, iterations,
                                     damping, R.data_ptr(), t.data_ptr(),
                                     cost.data_ptr(), _build.stream_ptr(R))
    _build.check(rc, "refine_gn")
    _build.LAUNCHES["refine_gn"] += 1
    return R, t, cost
