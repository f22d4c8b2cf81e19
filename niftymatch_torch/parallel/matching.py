"""All-pairs keyframe matching and sharded detection
(``parallel/matching.py`` of the JAX package).

* ``allpairs_match`` is the fp32 oracle on one device: ratio-test
  (optionally mutual) matches of every keyframe against every other, one
  distance GEMM per pair.
* ``allpairs_match_fused`` is the same sweep through K1 in its prepared
  form: all K*N rows against one keyframe's N rows per launch.
* ``ring_allpairs_match`` is the sweep over a keyframe mesh: each rank
  holds a block of keyframes (:func:`ring_rows`), matches it against the
  visiting block, and passes the visitor one hop round the ring
  (``comm.start_shift``, the counterpart of ``ppermute``) while it
  matches.
* ``shard_detect`` runs a batched detector on this rank's rows of a frame
  batch; ``gather_features`` collects every rank's rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..features import Features
from ..kernels.match import (
    NOVALID,
    _masked_norm,
    fused_match_topk_prepared,
    prepare_descriptors,
)
from ..ops.match import mutual_matches, pairwise_sq_distances, ratio_test_matches
from .comm import all_gather_rows, comm_device, start_shift
from .multihost import local_batch_slice


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


def _accept(min1, idx1, min2, a_valid, ambiguity):
    """K1's (min1, idx1, min2) -> ratio-test indices (-1 for none), the
    acceptance of ``ops.match._ratio_test`` (rows that saw no valid column
    report min1 >= 1e29)."""
    pos = min2 > 0.0
    ratio = min1 / torch.where(pos, min2, torch.ones_like(min2))
    ok = pos & (ratio < ambiguity) & (min1 < NOVALID) & a_valid
    return torch.where(ok, idx1, torch.full_like(idx1, -1))


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
        fwd.append(_accept(*fused_match_topk_prepared(mat, mat[rows], norm, norm_b[rows]),
                           flat_valid, ambiguity))
    # fwd[j][i * N + n]: the slot of frame j matched by slot n of frame i.
    idx = torch.stack(fwd).reshape(K, K, N).transpose(0, 1).contiguous()  # (i, j, n)
    if mutual:
        # back[i, j, n]: what frame j's slot idx[i, j, n] matches in frame i.
        back = torch.gather(idx.transpose(0, 1), -1, idx.clamp(min=0).long())
        n_ids = torch.arange(N, dtype=idx.dtype, device=idx.device)
        idx = torch.where((idx >= 0) & (back == n_ids), idx, torch.full_like(idx, -1))
    counts = (idx >= 0).sum(-1, dtype=torch.int32)
    return AllPairsMatches(counts, idx if return_indices else None)



# -- the ring over a keyframe mesh -------------------------------------------


class _Block(NamedTuple):
    """A block of k keyframes as the ring sweep matches it: fp32
    descriptors (k, N, D) contiguous, validity (k, N), squared norms
    (k, N) and the norms with invalid slots masked (as K1's B operand)."""

    desc: torch.Tensor
    valid: torch.Tensor
    norm: torch.Tensor
    norm_b: torch.Tensor


def _pack(desc, valid):
    """(k, N, D) + (k, N) -> (k, N, D + 2): the descriptors with validity
    and squared norm as two more columns, so that a ring step sends one
    message.  Each row's norm is a sum over its own D values, the same
    bits at every world size."""
    d32 = desc.to(torch.float32)
    norm = (d32 * d32).sum(dim=-1)
    return torch.cat([d32, valid[..., None].to(torch.float32), norm[..., None]], dim=-1)


def _unpack(packed) -> _Block:
    D = packed.shape[-1] - 2
    valid = packed[..., D] > 0.5
    norm = packed[..., D + 1].contiguous()
    return _Block(packed[..., :D].contiguous(), valid, norm, _masked_norm(norm, valid))


def _ring_block_match(res: _Block, vis: _Block, ambiguity: float, mutual: bool):
    """Resident (k, N) against visiting (kv, N) keyframes: ((k, kv) counts,
    (k, kv, N) indices).  On the card, K1 fp32: per visiting frame one
    launch of all k * N resident rows against its N rows, and with
    ``mutual`` one batched launch of its N rows against each resident
    frame (the backward direction, which the resident rank alone holds).
    On the CPU, the oracle (``_block_match``)."""
    if res.desc.device.type == "cpu":
        return _block_match(res.desc, res.valid, vis.desc, vis.valid, ambiguity, mutual)
    k, N, D = res.desc.shape
    a_mat, a_norm, a_valid = res.desc.view(k * N, D), res.norm.view(-1), res.valid.view(-1)
    n_ids = torch.arange(N, dtype=torch.int32, device=res.desc.device)
    cols = []
    for j in range(vis.desc.shape[0]):
        fwd = _accept(*fused_match_topk_prepared(a_mat, vis.desc[j], a_norm, vis.norm_b[j]),
                      a_valid, ambiguity).view(k, N)
        if mutual:
            bwd = _accept(*fused_match_topk_prepared(
                vis.desc[j].expand(k, N, D).contiguous(), res.desc,
                vis.norm[j].expand(k, N).contiguous(), res.norm_b),
                vis.valid[j].expand(k, N), ambiguity)
            back = torch.gather(bwd, -1, fwd.clamp(min=0).long())
            fwd = torch.where((fwd >= 0) & (back == n_ids), fwd, torch.full_like(fwd, -1))
        cols.append(fwd)
    idx = torch.stack(cols, dim=1)                                  # (k, kv, N)
    return (idx >= 0).sum(-1, dtype=torch.int32), idx


def ring_rows(num_frames: int, mesh, axis: str = "kf") -> slice:
    """The rows of a (num_frames, ...) keyframe batch that this rank holds
    in the ring's layout: blocks of ceil(num_frames / n) frames in rank
    order, the last ones short or empty (the ring pads them with
    all-invalid frames).  Equal to ``local_batch_slice`` where n divides
    the batch."""
    group = mesh.get_group(axis)
    n, me = dist.get_world_size(group), dist.get_rank(group)
    kl = -(-num_frames // n)
    return slice(min(me * kl, num_frames), min((me + 1) * kl, num_frames))


def ring_allpairs_match(desc: torch.Tensor, valid: torch.Tensor, mesh, axis: str = "kf",
                        ambiguity: float = 0.8, mutual: bool = False,
                        return_indices: bool = False, phase: str = "full",
                        num_frames: int | None = None) -> AllPairsMatches:
    """All-pairs keyframe matching, ring-scheduled over the mesh's ``axis``.

    Each rank passes only its own keyframes: ``desc`` (k, N, D) and
    ``valid`` (k, N) are its rows (:func:`ring_rows`) of the sharded
    (num_frames, N, D) batch, as ``shard_detect`` leaves them and as the
    JAX package's sharded input lays them out.  ``num_frames`` (K) may be
    left out where every rank holds the same k (K = n k); any K is padded
    to a multiple of the ranks with all-invalid frames, then cut back.  At
    each of the n steps a rank matches its block against the visiting
    block (which came from rank (me - s) % n) while the next transfer is
    in flight: it starts before the match and is waited on after it.  The
    last step sends nothing, so a sweep makes n - 1 hops.  Validity and
    the squared norms ride as two extra descriptor columns, one message a
    step.

    The block match is K1 fp32 on CUDA tensors (K launches a sweep over
    the ranks, 2K with ``mutual``) and the fp32 oracle on CPU tensors, as
    the JAX ring matches in fp32.  ``phase`` "compute" keeps the rank's
    own block resident (no transfers) and "comm" makes the transfers
    without matching: the two isolation modes that ``benchmarks/scaling.py``
    times, whose results are timings, not matches.

    Returns every rank the whole (K, K) counts and, with
    ``return_indices``, the (K, K, N) indices, gathered from the row
    blocks.  The diagonal is the trivial self-match."""
    if phase not in ("full", "compute", "comm"):
        raise ValueError(f"phase must be 'full', 'compute' or 'comm', got {phase!r}")
    group = mesh.get_group(axis)
    n, me = dist.get_world_size(group), dist.get_rank(group)
    k, N, D = desc.shape
    K = n * k if num_frames is None else num_frames
    rows = ring_rows(K, mesh, axis)
    if rows.stop - rows.start != k:
        raise ValueError(f"rank {me} holds {k} frames; its rows of {K} over {n} ranks "
                         f"are {rows.start}:{rows.stop}")
    kl = -(-K // n)
    own = _pack(desc, valid)
    if k < kl:
        own = torch.cat([own, own.new_zeros((kl - k, N, D + 2))])
    dev = desc.device
    res = vis = _unpack(own)
    vis_c = own.to(comm_device(group, dev))   # the visitor where it is sent from
    counts = torch.zeros((kl, n * kl), dtype=torch.int32, device=dev)
    idx = (torch.full((kl, n * kl, N), -1, dtype=torch.int32, device=dev)
           if return_indices else None)
    for s in range(n):
        owner = (me - s) % n
        cols = slice(owner * kl, (owner + 1) * kl)
        pending = start_shift(vis_c, group) if phase != "compute" and s + 1 < n else None
        if phase != "comm":
            c, i = _ring_block_match(res, vis, ambiguity, mutual)
            counts[:, cols] = c
            if idx is not None:
                idx[:, cols] = i
        if pending is not None:
            vis_c = pending.wait()
            vis = _unpack(vis_c.to(dev, non_blocking=True))
    counts = all_gather_rows(counts, group)[:K, :K]
    if idx is not None:
        idx = all_gather_rows(idx, group)[:K, :K]
    return AllPairsMatches(counts, idx)


def ring_allpairs_match_counts(desc: torch.Tensor, valid: torch.Tensor, mesh,
                               axis: str = "kf", ambiguity: float = 0.8,
                               num_frames: int | None = None) -> torch.Tensor:
    """Counts only: :func:`ring_allpairs_match`'s (K, K) counts."""
    return ring_allpairs_match(desc, valid, mesh, axis=axis, ambiguity=ambiguity,
                               num_frames=num_frames).counts


# -- sharded detection --------------------------------------------------------


def shard_detect(detect_fn, images, mesh, axis: str = "kf") -> Features:
    """Run a batched detector on this rank's rows of a frame batch.

    ``detect_fn`` maps a (k, H, W) batch to batched ``Features`` (for
    example ``lambda x: detect_and_describe_batch(x, cfg)``, which
    launches K2 and K3 once per batch); ``images`` is the (K, H, W) batch,
    the same on every rank, K divisible by the ranks.  Returns this rank's
    rows (``local_batch_slice``); :func:`gather_features` collects them."""
    n = mesh.get_group(axis).size()
    if n != dist.get_world_size():
        raise ValueError("shard_detect shards over every rank of the process group")
    K = images.shape[0]
    if K % n:
        raise ValueError(f"{K} frames do not split over {n} ranks")
    return detect_fn(images[local_batch_slice(K)])


def gather_features(feats: Features, mesh, axis: str = "kf") -> Features:
    """Every rank's rows of a sharded ``Features`` batch, in rank order."""
    group = mesh.get_group(axis)
    return Features(*[all_gather_rows(t, group) for t in feats])
