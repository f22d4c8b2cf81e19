"""Fused descriptor matching, kernel K1: distance GEMM + running top-2 in
one pass, the counterpart of ``niftymatch_tpu/pallas/match.py``.

For each A row: (min1, argmin1, min2) of ``||b||^2 - 2 a.b`` over the valid
B rows, then ``+ ||a||^2`` and a clamp at 0.  Invalid B rows enter with
``||b||^2 = 1e30``, so a row with no valid B reports ``min1 >= 1e29``.
Ties go to the lowest column.  Every function takes an optional leading
batch axis of pairs, and a batch is one launch.

``fused_match_topk`` takes CPU tensors to the plain version
(``fused_match_topk_plain``, a materialised distance matrix and
``ops.match.top2_min``) and CUDA tensors to the CUDA kernel
(``csrc/match.cu``); there is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.match import MatchResult, _ratio_test, top2_min
from . import _build

MASKVAL = 1e30   # ||b||^2 of an invalid B row
NOVALID = 1e29   # min1 above this: the row saw no valid B row

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P]
_SIGNATURES = {"nm_match_top2_f32": _ARGS, "nm_match_top2_bf16": _ARGS}


def prepare_descriptors(desc: torch.Tensor, bf16: bool = False):
    """``(mat, norm)``: the GEMM operand (bf16 or fp32, contiguous) and the
    fp32 squared norms of the unrounded descriptors.  (The Pallas version
    also returns ``-2 x``; this kernel applies the -2 itself.)"""
    d32 = desc.to(torch.float32)
    norm = (d32 * d32).sum(dim=-1)
    mat = d32.to(torch.bfloat16 if bf16 else torch.float32).contiguous()
    return mat, norm


def _masked_norm(b_norm: torch.Tensor, b_valid) -> torch.Tensor:
    if b_valid is None:
        return b_norm.contiguous()
    return torch.where(b_valid, b_norm, torch.full_like(b_norm, MASKVAL)).contiguous()


def fused_match_topk_plain(a_mat, b_mat, a_norm, b_norm):
    """Plain PyTorch K1 on prepared operands (``b_norm`` already masked)."""
    ab = torch.matmul(a_mat.to(torch.float32),
                      b_mat.to(torch.float32).transpose(-1, -2))
    d = b_norm[..., None, :] - 2.0 * ab
    min1, idx1, min2 = top2_min(d)
    return (torch.clamp(min1 + a_norm, min=0.0), idx1,
            torch.clamp(min2 + a_norm, min=0.0))


def fused_match_topk_prepared(a_mat, b_mat, a_norm, b_norm):
    """K1 on prepared operands: (..., M, 128) x (..., N, 128) with norms
    (..., M) and masked (..., N) -> (min1, idx1 int32, min2), each (..., M)."""
    if a_mat.device.type == "cpu":
        return fused_match_topk_plain(a_mat, b_mat, a_norm, b_norm)
    batched = a_mat.dim() == 3
    if not batched:
        a_mat, b_mat = a_mat[None], b_mat[None]
        a_norm, b_norm = a_norm[None], b_norm[None]
    if a_mat.dim() != 3 or b_mat.dim() != 3:
        raise ValueError("expected (M, D) or (P, M, D) descriptor operands")
    pairs, m, d = a_mat.shape
    n = b_mat.shape[1]
    if b_mat.dtype != a_mat.dtype or a_mat.dtype not in (torch.float32,
                                                         torch.bfloat16):
        raise ValueError("operands must both be float32 or both bfloat16")
    _build.require_cuda("a_mat", a_mat, a_mat.dtype, (pairs, m, d))
    _build.require_cuda("b_mat", b_mat, a_mat.dtype, (pairs, n, d))
    _build.require_cuda("a_norm", a_norm, torch.float32, (pairs, m))
    _build.require_cuda("b_norm", b_norm, torch.float32, (pairs, n))
    if d != 128:
        raise ValueError(f"the K1 kernel takes 128-D descriptors, got {d}")
    if a_mat.data_ptr() % 16 or b_mat.data_ptr() % 16:
        raise ValueError("the K1 kernel copies 16-byte aligned rows")
    kw = dict(device=a_mat.device)
    min1 = torch.empty((pairs, m), dtype=torch.float32, **kw)
    idx1 = torch.empty((pairs, m), dtype=torch.int32, **kw)
    min2 = torch.empty((pairs, m), dtype=torch.float32, **kw)
    lib = _build.load("match", _SIGNATURES)
    bf16 = a_mat.dtype == torch.bfloat16
    fn = lib.nm_match_top2_bf16 if bf16 else lib.nm_match_top2_f32
    rc = fn(a_mat.data_ptr(), b_mat.data_ptr(), a_norm.data_ptr(),
            b_norm.data_ptr(), pairs, m, n, d, min1.data_ptr(),
            idx1.data_ptr(), min2.data_ptr(), _build.stream_ptr(a_mat))
    _build.check(rc, "K1 match top-2")
    _build.LAUNCHES["k1_match_top2_bf16" if bf16 else "k1_match_top2"] += 1
    if not batched:
        return min1[0], idx1[0], min2[0]
    return min1, idx1, min2


def fused_match_topk(desc_a, desc_b, b_valid=None, bf16: bool = False):
    """Per-A-row (min1, argmin1, min2) squared L2 against the valid B rows."""
    a_mat, a_norm = prepare_descriptors(desc_a, bf16)
    b_mat, b_norm = prepare_descriptors(desc_b, bf16)
    return fused_match_topk_prepared(a_mat, b_mat, a_norm,
                                     _masked_norm(b_norm, b_valid))


def match_descriptors_fused(desc_a, desc_b, ambiguity: float = 0.8,
                            a_valid=None, b_valid=None,
                            precision: str = "fp32") -> MatchResult:
    """``ops.match.match_descriptors`` through K1: the same Lowe ratio test
    (``match.cu:82-117``) with no distance matrix stored."""
    if precision not in ("fp32", "bf16"):
        raise ValueError(f"precision must be 'fp32' or 'bf16', got {precision!r}")
    min1, idx1, min2 = fused_match_topk(desc_a, desc_b, b_valid,
                                        bf16=(precision == "bf16"))
    return _ratio_test(min1, idx1, min2, min1 < NOVALID, ambiguity, a_valid)
