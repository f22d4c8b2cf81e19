"""All-pairs keyframe matching on one device: the single-device half of
``parallel/matching.py`` of the JAX package.

``allpairs_match`` is the fp32 oracle: ratio-test (optionally mutual)
matches of every keyframe against every other, one distance GEMM per pair.
``allpairs_match_fused`` is the same sweep through K1 in its prepared
form: all K*N rows against one keyframe's N rows per launch.  The ring over
a device mesh (``ring_allpairs_match``) and ``shard_detect`` belong to the
multi-device layer and are not here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.match import (
    NOVALID,
    _masked_norm,
    fused_match_topk_prepared,
    prepare_descriptors,
)
from ..ops.match import mutual_matches, pairwise_sq_distances, ratio_test_matches


class AllPairsMatches(NamedTuple):
    """Result of an all-pairs keyframe sweep.

    ``counts[i, j]``: ratio-test (optionally mutual) matches from frame i
    to frame j.  ``indices[i, j, n]``: the slot of frame j matched by slot
    n of frame i (-1 for none), or None unless requested."""

    counts: torch.Tensor            # (K, K) int32
    indices: torch.Tensor | None    # (K, K, N) int32


def _pair_match(da, va, db, vb, ambiguity: float, mutual: bool, precision: str = "fp32"):
    """Ratio-test matches a -> b for one frame a against a batch of frames
    b ((B, N, D)): ((B,) int32 counts, (B, N) int32 indices).  ``mutual``
    cross-checks against the b -> a matches of the SAME distance matrix
    (its transpose: no second GEMM)."""
    d = pairwise_sq_distances(da, db, precision=precision)   # (B, N, N)
    fwd = ratio_test_matches(d, ambiguity, va, vb)
    idx = fwd.indices
    if mutual:
        bwd = ratio_test_matches(d.transpose(-1, -2), ambiguity, vb, va)
        idx = mutual_matches(fwd, bwd)
    return (idx >= 0).sum(-1, dtype=torch.int32), idx


def _block_match(desc_a, valid_a, desc_b, valid_b, ambiguity, mutual, precision="fp32"):
    """(Ka, N, D) x (Kb, N, D) -> ((Ka, Kb) counts, (Ka, Kb, N) indices)."""
    outs = [_pair_match(da, va, desc_b, valid_b, ambiguity, mutual, precision)
            for da, va in zip(desc_a, valid_a)]
    return torch.stack([c for c, _ in outs]), torch.stack([i for _, i in outs])


def allpairs_match(desc: torch.Tensor, valid: torch.Tensor, ambiguity: float = 0.8,
                   mutual: bool = False, return_indices: bool = False,
                   jblock: int = 8, precision: str = "fp32") -> AllPairsMatches:
    """Dense single-device all-pairs sweep, the fp32 oracle.

    Memory-blocked: every pairwise (N, N) distance matrix at once would be
    K^2 N^2 floats (64 GB at K = 128, N = 1024), so each row frame is
    matched against column blocks of ``jblock`` frames in turn and at most
    ``jblock`` distance matrices are alive at once, whatever K is.
    ``precision="bf16"`` rounds the GEMM operands to bf16 (norms fp32),
    the function ``allpairs_match_fused`` computes in bf16."""
    K = desc.shape[0]
    counts, idx = [], []
    for i in range(K):
        row = [_block_match(desc[i:i + 1], valid[i:i + 1], desc[j0:j0 + jblock],
                            valid[j0:j0 + jblock], ambiguity, mutual, precision)
               for j0 in range(0, K, jblock)]
        counts.append(torch.cat([c for c, _ in row], dim=1))
        if return_indices:
            idx.append(torch.cat([x for _, x in row], dim=1))
    return AllPairsMatches(torch.cat(counts),
                           torch.cat(idx) if return_indices else None)


def allpairs_match_fused(desc: torch.Tensor, valid: torch.Tensor, ambiguity: float = 0.8,
                         mutual: bool = False, return_indices: bool = False,
                         precision: str = "fp32") -> AllPairsMatches:
    """All-pairs sweep through K1, the counterpart of the JAX package's
    ``allpairs_match_pallas``.

    K tall-skinny launches: all K*N rows, prepared once, against one
    keyframe's N rows (norms of invalid slots masked) per launch, where K^2
    separate (N, N) products would each store a distance matrix.  On CUDA
    tensors each launch is K1 (``kernels/match.py``); on CPU tensors its
    plain version.  Mutuality comes from the forward table alone: slot n of
    frame i matching slot m of frame j is mutual iff frame j's slot m
    matches back to slot n of frame i, which is another row block of the
    same sweep.

    The same ratio test as ``allpairs_match`` at ``ambiguity``, -1 for no
    match, invalid slots excluded.  ``precision="bf16"`` rounds the GEMM
    operands to bf16: counts can then differ from the oracle's by ratio
    tests that flip within bf16 noise of the threshold, which is fine for
    loop-closure candidate detection (verification re-matches in fp32)."""
    if precision not in ("fp32", "bf16"):
        raise ValueError(f"precision must be 'fp32' or 'bf16', got {precision!r}")
    K, N, D = desc.shape
    mat, norm = prepare_descriptors(desc.reshape(K * N, D), bf16=(precision == "bf16"))
    flat_valid = valid.reshape(K * N)
    norm_b = _masked_norm(norm, flat_valid)
    fwd = []
    for j in range(K):
        rows = slice(j * N, (j + 1) * N)
        min1, idx1, min2 = fused_match_topk_prepared(mat, mat[rows], norm, norm_b[rows])
        pos = min2 > 0.0
        ratio = min1 / torch.where(pos, min2, torch.ones_like(min2))
        ok = pos & (ratio < ambiguity) & (min1 < NOVALID) & flat_valid
        fwd.append(torch.where(ok, idx1, torch.full_like(idx1, -1)))
    # fwd[j][i * N + n]: the slot of frame j matched by slot n of frame i.
    idx = torch.stack(fwd).reshape(K, K, N).transpose(0, 1).contiguous()  # (i, j, n)
    if mutual:
        # back[i, j, n]: what frame j's slot idx[i, j, n] matches in frame i.
        back = torch.gather(idx.transpose(0, 1), -1, idx.clamp(min=0).long())
        n_ids = torch.arange(N, dtype=idx.dtype, device=idx.device)
        idx = torch.where((idx >= 0) & (back == n_ids), idx, torch.full_like(idx, -1))
    counts = (idx >= 0).sum(-1, dtype=torch.int32)
    return AllPairsMatches(counts, idx if return_indices else None)

