"""Relocalisation: recovery after tracking loss (``slam/reloc.py`` of the
JAX package).

Two stages, as in the JAX package:

1. **score**: one batched mutual ratio-match count of the lost frame
   against the candidate keyframes, a plain descriptor GEMM
   (``ops/match.mutual_ratio_match``, as the JAX package computes it in
   ``jnp`` outside any kernel), no RANSAC.  Garbage frames score below
   ``min_inliers`` matches everywhere and stop here, after one fetch.
2. **verify**: ``slam_step`` (match with K1, E/H-RANSAC, triangulation) on
   the top ``VERIFY_K`` scored keyframes, a loop of calls in place of the
   JAX package's ``vmap``; the best is picked on the device and fetched
   with its results in one batch.

Candidates are the recent ``reloc_window`` tail plus a stride sample over
the whole map, padded to ``2 * reloc_window`` by repeating the last index.
"""

from __future__ import annotations

import numpy as np
import torch

from ..features import Features
from ..ops.match import mutual_ratio_match
from ..utils.precision import host_fetch
from ..utils.profiling import annotate
from .frontend import SlamStepResult, slam_step
from .keyframe import Keyframe

# Full slam_step runs on this many scored keyframes per attempt.
VERIFY_K = 4


class Relocalizer:
    """The miss counter, the backoff policy and the two query stages of one
    :class:`~.system.SlamSystem`."""

    def __init__(self, system):
        self._sys = system
        self.misses = 0  # consecutive rejected frames

    def note_miss(self) -> None:
        self.misses += 1

    def reset(self) -> None:
        self.misses = 0

    def due(self) -> bool:
        """Attempt relocalisation on this rejected frame?  Attempts fire at
        misses = after, after + 1, after + 2, then every 4th miss."""
        m, a = self.misses, self._sys.config.reloc_after
        if m < a:
            return False
        return m <= a + 2 or (m - a) % 4 == 0

    def _candidate_indices(self) -> list:
        """Recent tail + stride sample over the whole map, padded to
        2 * reloc_window (repeating the last index)."""
        cfg = self._sys.config
        K = len(self._sys.keyframes)
        W = min(K, cfg.reloc_window)
        idx = list(range(K - W, K))
        older = K - W
        if older > 0:
            stride = max(1, older // W)
            idx = list(range(0, older, stride))[:W] + idx
        pad = 2 * cfg.reloc_window - len(idx)
        return idx + [K - 1] * max(pad, 0)

    def _score(self, kf_feats_b: Features, feats: Features) -> torch.Tensor:
        """(K,) mutual ratio-test match counts of ``feats`` against each
        candidate: a necessary condition for ``slam_step`` success."""
        m = mutual_ratio_match(kf_feats_b.desc, kf_feats_b.valid, feats.desc,
                               feats.valid, ambiguity=0.8)
        return (m >= 0).sum(-1, dtype=torch.int32)

    def _verify(self, kfs, feats: Features):
        """``slam_step`` of ``feats`` against each keyframe of ``kfs``; the
        best by inliers among the successes, picked on the device (the
        first on ties, as ``jnp.argmax``): (best (1,), its result)."""
        sys_ = self._sys
        outs = [slam_step(kf.feats, feats, kf.pose, *sys_._context(kf), sys_.intrinsics,
                          sys_.config.ransac, scores=sys_.scores(feats), device=sys_.device)
                for kf in kfs]
        stacked = SlamStepResult(*[torch.stack(f) for f in zip(*outs)])
        score = torch.where(stacked.success, stacked.num_inliers,
                            torch.full_like(stacked.num_inliers, -1))
        best = torch.argmax(score).reshape(1)
        return best, SlamStepResult(*[f.index_select(0, best)[0] for f in stacked])

    def prewarm(self) -> None:
        """One score and one verify of keyframe 0 against itself, results
        discarded: a warm-up of the libraries the queries call (nothing is
        compiled).  A no-op before the first keyframe."""
        sys_ = self._sys
        if not sys_.keyframes:
            return
        kf0 = sys_.keyframes[0]
        W2 = 2 * sys_.config.reloc_window
        self._score(sys_._store.gather([kf0.slot] * W2), kf0.feats)
        host_fetch(self._verify([kf0] * VERIFY_K, kf0.feats)[0])

    def maybe_relocalize(self, feats: Features) -> dict | None:
        """Recovery query after ``reloc_after`` consecutive rejections.

        Score the lost frame against the candidates (one fetch); when the
        best count reaches ``min_inliers``, verify against the top
        ``VERIFY_K`` distinct keyframes and re-anchor at the best success
        (one more fetch).  Returns the frame's info dict, or None when
        recovery fails.  Under a profiler: the region ``nm.slam.reloc``."""
        with annotate("nm.slam.reloc"):
            return self._relocalize(feats)

    def _relocalize(self, feats: Features) -> dict | None:
        sys_ = self._sys
        cfg = sys_.config
        if min(len(sys_.keyframes), cfg.reloc_window) < 1:
            return None
        idx = self._candidate_indices()
        kfs = [sys_.keyframes[i] for i in idx]
        (counts,) = host_fetch(self._score(sys_._store.gather([k.slot for k in kfs]), feats))
        if int(counts.max()) < cfg.min_inliers:
            return None  # nothing can verify
        # Top VERIFY_K distinct keyframes by count (the padding repeats an
        # index), the first of equal counts first.
        top = []
        for o in np.argsort(-counts, kind="stable"):
            if idx[o] not in top:
                top.append(int(idx[o]))
            if len(top) == VERIFY_K:
                break
        top += [top[0]] * (VERIFY_K - len(top))
        kfs_v = [sys_.keyframes[i] for i in top]
        best, out = self._verify(kfs_v, feats)
        b, ok, n_inl, m_idx, inl, pts_w, valid_w, xs, ys = host_fetch(
            best, out.success, out.num_inliers, out.indices, out.inliers, out.points_w,
            out.points_valid, feats.x, feats.y)
        if not bool(ok) or int(n_inl) < cfg.min_inliers:
            return None
        anchor = kfs_v[int(b[0])]
        kf = Keyframe(
            index=len(sys_.keyframes),
            feats=feats,
            pose=out.pose,
            track_ids=np.full((xs.shape[0],), -1, np.int64),
            host_x=xs,
            host_y=ys,
            store=sys_._store,
            slot=sys_._store.stage_single(feats),
        )
        tracked = sys_._propagate_tracks(anchor, kf, m_idx=m_idx, inl=inl,
                                         pts_w=pts_w, valid_w=valid_w)
        sys_.keyframes.append(kf)
        self.misses = 0
        sys_._frames_since_ba += 1
        return {
            "keyframe": True,
            "num_inliers": int(n_inl),
            "tracked": tracked,
            "reloc": True,
            "anchor": anchor.index,
        }
