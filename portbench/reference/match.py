"""Plain ratio-test matching: pairs of images and the all-pairs sweep.

Squared distances ``||a||^2 + ||b||^2 - 2 a.b`` with the norms of the
unrounded float32 descriptors; a row matches its nearest valid column
(the lowest column among equal distances) when ``min1 / min2 < ambiguity``
and ``min2 > 0``; -1 marks no match.  ``mode`` is the precision of the
product's operands: ``fp32`` (TF32 off), ``bf16``, and the controls one
step below each, ``tf32`` (operands rounded to TF32's 10-bit mantissa,
products summed in float32, as a TF32 tensor core does) and ``fp8``
(operands scaled by 2^9, rounded to float8 e4m3).
"""

from __future__ import annotations

import torch

MODES = ("fp32", "tf32", "bf16", "fp8")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties to even), kept as float32."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


def operand(x: torch.Tensor, mode: str) -> torch.Tensor:
    x = x.to(torch.float32)
    if mode == "fp32":
        return x
    if mode == "tf32":
        return round_tf32(x)
    if mode == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if mode == "fp8":
        return (x * 512.0).to(torch.float8_e4m3fn).to(torch.float32) / 512.0
    raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def top2_accept(d: torch.Tensor, a_valid: torch.Tensor, ambiguity: float) -> torch.Tensor:
    """(..., A, B) distances with invalid columns at +inf -> (..., A) int32
    indices of the accepted matches, -1 elsewhere."""
    min1, idx1 = torch.min(d, dim=-1)
    cols = torch.arange(d.shape[-1], device=d.device)
    min2 = torch.where(cols == idx1[..., None], torch.full_like(d, float("inf")), d).min(-1).values
    pos = min2 > 0.0
    ratio = min1 / torch.where(pos, min2, torch.ones_like(min2))
    ok = pos & (ratio < ambiguity) & torch.isfinite(min1) & a_valid
    return torch.where(ok, idx1.to(torch.int32), torch.full_like(idx1, -1, dtype=torch.int32))


def distances(a: torch.Tensor, b: torch.Tensor, b_valid: torch.Tensor, mode: str) -> torch.Tensor:
    """(..., A, D) x (..., B, D) -> (..., A, B), invalid B columns +inf."""
    _no_tf32()
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    an, bn = (a32 * a32).sum(-1), (b32 * b32).sum(-1)
    ab = torch.matmul(operand(a32, mode), operand(b32, mode).transpose(-1, -2))
    d = torch.clamp(an[..., :, None] + bn[..., None, :] - 2.0 * ab, min=0.0)
    return torch.where(b_valid[..., None, :], d, torch.full_like(d, float("inf")))


def pair_match(desc_a, valid_a, desc_b, valid_b, ambiguity: float, mode: str = "fp32"):
    """Ratio-test matches A -> B of each pair: (..., A) int32."""
    return top2_accept(distances(desc_a, desc_b, valid_b, mode), valid_a, ambiguity)


def allpairs(desc: torch.Tensor, valid: torch.Tensor, ambiguity: float, mutual: bool,
             mode: str = "fp32"):
    """The all-pairs sweep of K frames of N slots: ((K, K) int32 counts,
    (K, K, N) int32 indices); ``indices[i, j, n]`` is the slot of frame j
    matched by slot n of frame i.  One frame's columns at a time, so at
    most a (K N, N) distance matrix is alive."""
    K, N, D = desc.shape
    flat, fvalid = desc.reshape(K * N, D), valid.reshape(K * N)
    fwd = torch.stack([
        pair_match(flat, fvalid, desc[j], valid[j], ambiguity, mode) for j in range(K)
    ])                                                   # (j, i * N + n)
    idx = fwd.reshape(K, K, N).transpose(0, 1).contiguous()
    if mutual:
        back = torch.gather(idx.transpose(0, 1), -1, idx.clamp(min=0).long())
        n_ids = torch.arange(N, dtype=idx.dtype, device=idx.device)
        idx = torch.where((idx >= 0) & (back == n_ids), idx, torch.full_like(idx, -1))
    return (idx >= 0).sum(-1, dtype=torch.int32), idx


def allpairs_decided(desc: torch.Tensor, valid: torch.Tensor, ambiguity: float, mutual: bool,
                     margin: float):
    """The all-pairs sweep in float64, and which of its answers a float32
    computation decides: ``(indices, sure)``, both (K, K, N).  A row's
    ratio test is decided when its distances clear the threshold by more
    than ``margin`` (``|min1 - ambiguity min2| > margin``); a mutual entry
    when its forward test is decided and, if it matched, the backward test
    of the slot it matched too.  Between views a few degrees apart the best
    distance is of the order of float32's cancellation error in ``2 - 2 a.b``,
    and there the ratio test reads rounding, whichever side computes it."""
    K, N, D = desc.shape
    flat = desc.reshape(K * N, D).to(torch.float64)
    fvalid = valid.reshape(K * N)
    fnorm = (flat * flat).sum(-1)
    cols = torch.arange(N, device=desc.device)
    fwd, sure = [], []
    for j in range(K):
        b = desc[j].to(torch.float64)
        d = torch.clamp(fnorm[:, None] + (b * b).sum(-1)[None, :] - 2.0 * flat @ b.T, min=0.0)
        d = torch.where(valid[j][None, :], d, torch.full_like(d, float("inf")))
        min1, idx1 = torch.min(d, dim=-1)
        min2 = torch.where(cols == idx1[:, None], torch.full_like(d, float("inf")), d).min(-1).values
        del d
        pos = min2 > 0.0
        ratio = min1 / torch.where(pos, min2, torch.ones_like(min2))
        ok = pos & (ratio < ambiguity) & torch.isfinite(min1) & fvalid
        fwd.append(torch.where(ok, idx1.to(torch.int32), torch.full_like(idx1, -1, dtype=torch.int32)))
        gap = torch.where(torch.isfinite(min2), (min1 - ambiguity * min2).abs(),
                          torch.full_like(min1, float("inf")))
        sure.append(~fvalid | ~torch.isfinite(min1) | (gap > margin))
    idx = torch.stack(fwd).reshape(K, K, N).transpose(0, 1).contiguous()
    sure = torch.stack(sure).reshape(K, K, N).transpose(0, 1).contiguous()
    if mutual:
        at = idx.clamp(min=0).long()
        back = torch.gather(idx.transpose(0, 1), -1, at)
        back_sure = torch.gather(sure.transpose(0, 1), -1, at)
        sure = sure & ((idx < 0) | back_sure)
        n_ids = torch.arange(N, dtype=idx.dtype, device=idx.device)
        idx = torch.where((idx >= 0) & (back == n_ids), idx, torch.full_like(idx, -1))
    return idx, sure
