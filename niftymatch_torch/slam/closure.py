"""Loop closure for the keyframe SLAM system (``slam/closure.py`` of the JAX
package), in four stages:

  1. **candidate sweep** (:meth:`LoopCloser.detect_candidates`): all-pairs
     mutual match counts of the live keyframes, through K1 in bf16 on the
     card (``parallel.allpairs_match_fused``, the TPU's choice) and the
     fp32 oracle on the CPU (``parallel.allpairs_match``), or through the
     ring over a keyframe mesh when a process group of more than one rank
     is initialised (``parallel.ring_allpairs_match``);
  2. **verification** (:meth:`LoopCloser.verify_candidates`): per batch of
     ``loop_verify_batch`` candidate pairs one fp32 mutual re-match and
     ``two_view_from_matches`` for each pair, fetched once;
  3. **edge building** (:meth:`LoopCloser.build_loop_edges`): a Sim(3)
     measurement per verified candidate, its relative scale from landmark
     pair-distance ratios with a depth-median fallback (host numpy);
  4. **solve and apply** (:meth:`LoopCloser.solve_sim3_graph`,
     :meth:`LoopCloser.apply_sim3_correction`): the Sim(3) pose graph (dense
     LM, or matrix-free CG for large graphs), the gauge-sanity gates, and
     the landmark correction through each track's last observing keyframe.

:meth:`LoopCloser.close_loops` chains the stages; :meth:`LoopCloser.finalize`
alternates closure with global BA and rolls a round back when the
re-detected graph's initial cost rises.

Differences from the JAX package, none of them in what is computed: the
JAX package pads the sweep to the store's capacity, candidate batches to a
power of two and the Sim(3) graph to power-of-two node and edge counts, so
that its compiled programs are reused; here nothing is compiled, so the
sweep covers the K live keyframes, a batch holds its candidates and the
graph its nodes and edges (padded nodes are fixed and disconnected and
padded edges have weight 0, so the solve is the same).  The solver and CG
budget are still chosen from the padded node count, as the JAX package
chooses them.  The JAX package's ``vmap`` of the two-view check becomes a
loop of ``two_view_from_matches`` calls with the system's one RANSAC draw,
which its ``vmap`` reuses on every pair.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..features import Features
from ..ops.match import MatchResult, mutual_ratio_match
from ..parallel.matching import (
    allpairs_match,
    allpairs_match_fused,
    ring_allpairs_match,
    ring_rows,
)
from ..parallel.mesh import make_keyframe_mesh
from ..sfm.posegraph import Sim3Graph, optimize_pose_graph_sim3, optimize_pose_graph_sim3_cg
from ..utils.precision import device_constant, host_fetch
from .frontend import two_view_from_matches

AMBIGUITY = 0.7   # the sweep's and the re-match's Lowe ratio


class VerifiedCandidates(NamedTuple):
    """Batched two-view verification of candidate pairs (host arrays)."""

    cand_idx: np.ndarray  # (C, N) int32 match indices a-slot -> b-slot
    ok: np.ndarray        # (C,) bool RANSAC success
    ninl: np.ndarray      # (C,) int32 inlier counts
    pts: np.ndarray       # (C, N, 3) unit-baseline triangulations (frame j)
    pv: np.ndarray        # (C, N) bool cheirality & inlier
    R: np.ndarray         # (C, 3, 3)
    t: np.ndarray         # (C, 3) unit translation


def _relative(Ti: np.ndarray, Tj: np.ndarray) -> np.ndarray:
    """``se3_compose(Ti, se3_inverse(Tj))`` of (..., 3, 4) host poses."""
    R = Ti[..., :3] @ np.swapaxes(Tj[..., :3], -1, -2)
    t = Ti[..., 3] - np.einsum("...ij,...j->...i", R, Tj[..., 3])
    return np.concatenate([R, t[..., None]], axis=-1)


def _set_poses(sys_, poses_h: np.ndarray) -> None:
    """Keyframe k's pose := row k of ``poses_h``, uploaded in one copy."""
    dev = device_constant(np.array(poses_h, np.float32), sys_.device)
    for k in range(poses_h.shape[0]):
        sys_.keyframes[k].pose = dev[k]


class LoopCloser:
    """The loop-closure stages of one :class:`~.system.SlamSystem`.

    Map state (keyframes, track positions and liveness, the feature store)
    stays on the system, whose host arrays are replaced when they grow, so
    the closer reads them through ``self._sys`` every time."""

    def __init__(self, system):
        self._sys = system
        self.last_stages: dict = {}
        # Loop edges of the most recent APPLIED closure: measurements that
        # later optimisations must stay consistent with
        # (see loop_edge_consistency).
        self.last_loop_edges: tuple | None = None
        self._mesh = None

    # ------------------------------------------------------------------
    # Stage 1: candidate sweep
    # ------------------------------------------------------------------
    def sweep(self):
        """Mutual match counts of every live keyframe against every other,
        read from the feature store (slot k is keyframe k).  Where a
        process group of more than one rank is initialised, every rank
        passes its rows of the store (``ring_rows``) to the ring over its
        keyframe mesh (``ring_allpairs_match``, fp32: K1 on the card, the
        oracle on the CPU), as the JAX package shards the store over its
        ring when more than one device is visible; otherwise K1 in bf16 on the card and the fp32
        oracle on the CPU.  Counts only: the candidates' indices come from
        a batched re-match of just those pairs."""
        K = len(self._sys.keyframes)
        buf = self._sys._store.view()
        desc, valid = buf.desc[:K], buf.valid[:K]
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            if self._mesh is None:
                self._mesh = make_keyframe_mesh(device_type=desc.device.type)
            rows = ring_rows(K, self._mesh)
            return ring_allpairs_match(desc[rows], valid[rows], self._mesh,
                                       ambiguity=AMBIGUITY, mutual=True, num_frames=K)
        if desc.device.type == "cuda":
            return allpairs_match_fused(desc, valid, ambiguity=AMBIGUITY, mutual=True,
                                        precision="bf16")
        return allpairs_match(desc, valid, ambiguity=AMBIGUITY, mutual=True)

    def detect_candidates(self, return_matches: bool = False):
        """All-pairs sweep -> candidate (i, j, count) triples (i < j,
        j - i >= loop_min_gap) with at least ``loop_min_matches`` mutual
        matches.  With ``return_matches`` the candidate pairs are also
        re-matched (:meth:`match_keyframes`)."""
        cfg = self._sys.config
        K = len(self._sys.keyframes)
        if K < cfg.loop_min_gap + 2:
            return ([], None) if return_matches else []
        (counts,) = host_fetch(self.sweep().counts)
        hit = counts >= cfg.loop_min_matches
        iu, ju = np.nonzero(np.triu(hit, k=cfg.loop_min_gap))
        cands = [(int(i), int(j), int(counts[i, j])) for i, j in zip(iu, ju)]
        if not return_matches:
            return cands
        if not cands:
            return [], None
        return cands, self.match_keyframes([(c[0], c[1]) for c in cands])

    def gather_pairs(self, pairs):
        """Both sides of a keyframe-pair list from the store: one gather
        per side."""
        store = self._sys._store
        return store.gather([p[0] for p in pairs]), store.gather([p[1] for p in pairs])

    @staticmethod
    def _cand_match(fa: Features, fb: Features) -> torch.Tensor:
        """fp32 mutual ratio-test matches of each pair of the batch (plain
        torch: the JAX package computes them in ``jnp``)."""
        return mutual_ratio_match(fa.desc, fa.valid, fb.desc, fb.valid,
                                  ambiguity=AMBIGUITY)

    def match_keyframes(self, pairs) -> np.ndarray:
        """Mutual ratio-test match indices for keyframe pairs [(a, b), ...],
        ``loop_verify_batch`` pairs per batch (a batch stores one N x N
        distance matrix per pair).  Returns (len(pairs), N) int32: the slot
        of b matched by slot n of a, -1 if none."""
        if not pairs:
            return np.zeros((0, 0), np.int32)
        B = self._sys.config.loop_verify_batch
        outs = []
        for lo in range(0, len(pairs), B):
            (idx,) = host_fetch(self._cand_match(*self.gather_pairs(pairs[lo:lo + B])))
            outs.append(idx)
        return np.concatenate(outs)

    # ------------------------------------------------------------------
    # Stage 2: geometric verification
    # ------------------------------------------------------------------
    def verify_candidates(self, cands) -> VerifiedCandidates:
        """Re-match and two-view verification of candidate pairs: per batch
        one batched re-match, one ``two_view_from_matches`` per pair (each
        with the system's RANSAC draw) and one fetch.  The results are host
        arrays aligned with ``cands``."""
        sys_ = self._sys
        cfg = sys_.config
        B = cfg.loop_verify_batch
        fields = ("success", "num_inliers", "points", "point_valid", "R", "t")
        parts = []
        for lo in range(0, len(cands), B):
            fa, fb = self.gather_pairs([(c[0], c[1]) for c in cands[lo:lo + B]])
            idx = self._cand_match(fa, fb)
            tvs = []
            for p in range(idx.shape[0]):
                a = Features(*[x[p] for x in fa])
                b = Features(*[x[p] for x in fb])
                m = MatchResult(indices=idx[p],
                                distances=torch.zeros_like(idx[p], dtype=torch.float32),
                                ratios=torch.ones_like(idx[p], dtype=torch.float32))
                s_e, s_h = sys_.scores(a)
                tvs.append(two_view_from_matches(a, b, m, sys_.intrinsics, cfg.ransac,
                                                 scores_e=s_e, scores_h=s_h,
                                                 device=sys_.device))
            parts.append(host_fetch(idx, *[torch.stack([getattr(tv, f) for tv in tvs])
                                           for f in fields]))
        cat = [np.concatenate(x) for x in zip(*parts)]
        return VerifiedCandidates(cand_idx=cat[0], ok=cat[1].astype(bool), ninl=cat[2],
                                  pts=cat[3], pv=cat[4].astype(bool), R=cat[5], t=cat[6])

    # ------------------------------------------------------------------
    # Stage 3: Sim(3) edge building
    # ------------------------------------------------------------------
    def build_loop_edges(self, cands, ver: VerifiedCandidates, poses_h: np.ndarray):
        """Sim(3) measurements for verified candidates.

        Returns parallel lists (edges_i, edges_j, edges_s, edges_T,
        weights, consistency, ninls) for the ACCEPTED loop edges."""
        sys_ = self._sys
        cfg = sys_.config
        edges_i, edges_j, edges_s, edges_T = [], [], [], []
        weights, consistency, ninls = [], [], []
        for c, (j, i, _cnt) in enumerate(cands):  # j < i: edge i -> j
            if not bool(ver.ok[c]) or int(ver.ninl[c]) < cfg.loop_min_matches:
                continue
            kf_j, kf_i = sys_.keyframes[j], sys_.keyframes[i]
            # Scale of the unit-baseline triangulation in EACH frame's
            # local map: s_j from kf_j's tracks against unit depths in j,
            # s_i from kf_i's tracks against the same points moved to i.
            pose_j = poses_h[j]
            pose_i = poses_h[i]
            s_j = self.scale_vs_unit(kf_j, ver.pts[c], ver.pv[c], pose_j)
            pts_i = ver.pts[c] @ ver.R[c].T + ver.t[c]
            midx = ver.cand_idx[c]
            s_i = self.scale_vs_unit(kf_i, pts_i, ver.pv[c] & (midx >= 0), pose_i,
                                     slot_map=midx)
            if s_j is None or s_i is None:
                continue
            # Measurement Z = S_i o S_j^-1.  The relative map scale comes
            # preferably from pair-distance ratios of the two keyframes'
            # stored landmarks over the matched slots (a direct
            # observation of scale_i / scale_j, blind to the drifted rigid
            # alignment between the two map epochs); the ratio of the two
            # depth medians is the fallback when too few matched slots are
            # tracked on both sides.
            s_pairs = (None if os.environ.get("NIFTYMATCH_EDGE_SCALE") == "median"
                       else self.edge_scale_pairs(kf_j, kf_i, midx))
            s_med = s_i / s_j if s_j > 0 else np.nan
            # The median has the lower variance but mixes landmark birth
            # epochs on long loops; the pair ratio is epoch-robust but
            # noisier.  Take the median when the two agree within 20 % in
            # log, else the pair estimate.
            if s_pairs is None:
                s_rel = s_med
            elif np.isfinite(s_med) and abs(np.log(max(s_med, 1e-9) / s_pairs)) < 0.2:
                s_rel = s_med
            else:
                s_rel = s_pairs
                # Translation in i's local metric: the baseline in j's
                # metric (the reliable j-side median) times the ratio.
                if s_j > 0:
                    s_i = s_j * s_pairs
            T_rel = np.concatenate([ver.R[c], (s_i * ver.t[c])[:, None]],
                                   axis=-1).astype(np.float32)
            if not (np.isfinite(s_rel) and 1e-4 < s_rel < 1e4 and np.isfinite(T_rel).all()):
                continue
            pred = _relative(pose_i, pose_j)
            # Edge inconsistency against the current poses: relative
            # translation gap plus squared log-scale.  It sets the
            # iteration budget in solve_sim3_graph.
            dt = float(np.sum((T_rel[:, 3] - pred[:, 3]) ** 2))
            cons = dt / (1.0 + float(np.sum(pred[:, 3] ** 2)))
            cons += float(np.log(max(s_rel, 1e-9)) ** 2)
            if os.environ.get("NIFTYMATCH_DEBUG_CLOSURE"):
                print(f"edge {j}->{i}: s_j={s_j:.4f} s_i={s_i:.4f} "
                      f"s_rel={s_rel:.4f} ninl={int(ver.ninl[c])} "
                      f"cons={cons:.4f}\n"
                      f"  T_meas t={T_rel[:, 3]}\n  T_pred t={pred[:, 3]}")
            edges_i.append(i)
            edges_j.append(j)
            edges_s.append(s_rel)
            edges_T.append(T_rel)
            weights.append(cfg.loop_weight)
            consistency.append(cons)
            ninls.append(int(ver.ninl[c]))
        return edges_i, edges_j, edges_s, edges_T, weights, consistency, ninls

    def odometry_edges(self, poses_h: np.ndarray):
        """Consecutive-keyframe SE(3) edges from the current (BA-refined)
        host poses."""
        K = poses_h.shape[0]
        Z_all = _relative(poses_h[1:], poses_h[:-1]).astype(np.float32)
        return (list(range(1, K)), list(range(0, K - 1)), [1.0] * (K - 1),
                [Z_all[k] for k in range(K - 1)], [1.0] * (K - 1))

    # ------------------------------------------------------------------
    # close_loops: chain the stages
    # ------------------------------------------------------------------
    def close_loops(self) -> int:
        """Verify loop candidates geometrically, build a Sim(3) pose graph
        of odometry and loop edges, optimise it, and update keyframe poses
        AND landmark positions.  Returns the number of applied loop edges.

        Monocular odometry drifts in scale as well as pose, so the graph is
        over Sim(3) (Strasdat RSS 2010, ORB-SLAM's loop closing): each loop
        edge carries a relative scale from landmark ratios at both ends,
        and the optimiser spreads the scale error around the loop.
        Landmarks move with their last observing keyframe's Sim(3) update,
        which keeps their projection in that keyframe."""
        sys_ = self._sys
        stage_t0 = time.perf_counter()
        stages: dict = {}

        def mark(name):
            nonlocal stage_t0
            now = time.perf_counter()
            stages[name] = round(now - stage_t0, 3)
            stage_t0 = now

        self.last_stages = stages
        sys_.flush_ba()
        mark("flush_ba_s")
        cands = self.detect_candidates()
        mark("candidate_sweep_s")
        K = len(sys_.keyframes)
        poses_h = sys_.poses()   # one stacked fetch, reused below
        edges_i, edges_j, edges_s, edges_T, weights = self.odometry_edges(poses_h)
        cands = self.select_candidates(cands)
        edge_consistency: list = []
        edge_ninls: list = []
        accepted = 0
        if cands:
            ver = self.verify_candidates(cands)
            li, lj, ls, lT, lw, cons, ninls = self.build_loop_edges(cands, ver, poses_h)
            cap = getattr(sys_.config, "loop_max_edges", 0)
            if cap and len(li) > cap:
                # Keep the best-verified edges by inliers: near-duplicate
                # edges beyond them add solver cost and gate risk and no
                # information.
                order = sorted(np.argsort(-np.asarray(ninls), kind="stable")[:cap])
                li, lj, ls, lT, lw, cons, ninls = (
                    [xs[o] for o in order] for xs in (li, lj, ls, lT, lw, cons, ninls))
            edges_i += li
            edges_j += lj
            edges_s += ls
            edges_T += lT
            weights += lw
            edge_consistency = cons
            edge_ninls = ninls
            accepted = len(li)
        # Candidate detection and verification do not read the map, edge
        # building does (scale estimation): finalize's rollback compares
        # these counts between rounds.
        stages["loop_candidates"] = len(cands)
        stages["loop_edges_built"] = accepted
        mark("verify_s")
        if accepted == 0:
            return 0
        n_odo = K - 1
        loop_ids = list(range(n_odo, len(weights)))
        applied_edges = 0
        # If the full edge set fails the gates (a few wrong edges that
        # agree with each other can defeat even the Huber kernel), retry
        # once with the better-verified half of the loop edges.
        for attempt in (0, 1):
            sel = loop_ids
            if attempt == 1:
                if len(loop_ids) < 4:
                    break
                med_ninl = float(np.median([edge_ninls[e - n_odo] for e in loop_ids]))
                sel = [e for e in loop_ids if edge_ninls[e - n_odo] >= med_ninl]
                if len(sel) == len(loop_ids):
                    break
            keep = list(range(n_odo)) + sel
            ok, scale_o, poses_o = self.solve_sim3_graph(
                K,
                [edges_i[e] for e in keep],
                [edges_j[e] for e in keep],
                [edges_s[e] for e in keep],
                [edges_T[e] for e in keep],
                [weights[e] for e in keep],
                [edge_consistency[e - n_odo] for e in keep if e >= n_odo],
                stages,
                poses_h=poses_h,
            )
            if ok:
                applied_edges = len(sel)
                applied_sel = sel
                break
        mark("posegraph_s")
        if not applied_edges:
            return 0
        self.apply_sim3_correction(np.asarray(scale_o), np.asarray(poses_o), poses_h)
        self.last_loop_edges = (
            [edges_i[e] for e in applied_sel],
            [edges_j[e] for e in applied_sel],
            [edges_s[e] for e in applied_sel],
            [np.asarray(edges_T[e]) for e in applied_sel],
        )
        mark("apply_s")
        return applied_edges

    def select_candidates(self, cands):
        """Downselect candidates BEFORE verification.

        * **temporal non-max suppression**: a dense revisit gives blocks of
          near-duplicate (i, j) pairs; within an (nms x nms) window of the
          (i, j) grid only the best-matched pair survives;
        * **cap**: keep the ``max_loop_candidates`` best-matched."""
        cfg = self._sys.config
        nms = getattr(cfg, "loop_candidate_nms", 0)
        if nms and len(cands) > 1:
            kept: list = []
            for i, j, cnt in sorted(cands, key=lambda c: -c[2]):
                if any(abs(i - ki) <= nms and abs(j - kj) <= nms for ki, kj, _ in kept):
                    continue
                kept.append((i, j, cnt))
            kept.sort()
            cands = kept
        if len(cands) > cfg.max_loop_candidates:
            cands = sorted(cands, key=lambda c: -c[2])[: cfg.max_loop_candidates]
            cands.sort()
        return cands

    # ------------------------------------------------------------------
    # Stage 4: Sim(3) solve + apply
    # ------------------------------------------------------------------
    def solve_sim3_graph(self, K, edges_i, edges_j, edges_s, edges_T, weights,
                         loop_consistency, _stages, poses_h=None):
        """Solve the Sim(3) graph of K nodes (node 0 fixed) and the given
        edges, and apply the sanity gates.  Returns (ok, node_scales,
        node_poses) as host arrays.  ``poses_h``: the keyframes' (K, 3, 4)
        poses, fetched here when not given.

        The dense solver below 512 nodes and matrix-free CG from there,
        counted as the JAX package counts them: on the node count padded
        to a power of two (at least 16)."""
        sys_ = self._sys
        if poses_h is None:
            poses_h = sys_.poses()
        E = len(weights)
        fixed = np.zeros(K, bool)
        fixed[0] = True
        graph = Sim3Graph(
            scale=np.ones(K, np.float32),
            poses=np.asarray(poses_h, np.float32),
            edge_i=np.asarray(edges_i, np.int32),
            edge_j=np.asarray(edges_j, np.int32),
            edge_s=np.asarray(edges_s, np.float32),
            edge_T=np.stack(edges_T).astype(np.float32),
            edge_weight=np.asarray(weights, np.float32),
            edge_valid=np.ones(E, bool),
            node_fixed=fixed,
        )
        k_pad = 1 << int(np.ceil(np.log2(max(K, 16))))
        # Iteration budget from the measured graph inconsistency: a graph
        # whose loop edges already agree with the poses (mean consistency
        # below 1e-2) gets a mild early-stopped correction, since running
        # it to convergence only fits measurement noise; a drifted graph
        # needs the full budget.
        mean_cons = float(np.mean(loop_consistency)) if loop_consistency else 0.0
        iters = 12 if mean_cons < 1e-2 else 48
        if k_pad >= 512:
            # The dense 7N x 7N system is O(K^2) memory and O(K^3) to
            # solve; the block-sparse CG solver is O(K + E).
            out, stats = optimize_pose_graph_sim3_cg(
                graph, iterations=iters, damping=1e-4,
                cg_iterations=max(64, min(256, k_pad // 5)), huber_delta=1.0,
                device=sys_.device)
        else:
            out, stats = optimize_pose_graph_sim3(graph, iterations=iters, damping=1e-4,
                                                  huber_delta=1.0, device=sys_.device)
        c0, c1, scale_o, poses_o = host_fetch(stats.initial_cost, stats.final_cost,
                                              out.scale, out.poses)
        _stages["pg_edges"] = E - (K - 1)
        _stages["pg_cost"] = [float(c0), float(c1)]
        log_s = np.abs(np.log(np.clip(scale_o, 1e-12, 1e12)))
        med_log_s = float(np.median(log_s))
        max_log_s = float(np.max(log_s))
        _stages["pg_med_log_scale"] = round(med_log_s, 4)
        _stages["pg_max_log_scale"] = round(max_log_s, 4)
        if not (float(c1) <= float(c0)) or med_log_s > 1.0 or max_log_s > 4.0:
            # Rejected: the cost rose, or the correction rescales the median
            # node by more than e or any node by more than e^4 (node 0 is
            # fixed, so node scales are relative drift, and a legitimate
            # correction keeps them moderate).
            return False, None, None
        return True, scale_o, poses_o

    def edge_scale_pairs(self, kf_j, kf_i, midx, min_pts: int = 8) -> float | None:
        """Relative map scale (scale_i / scale_j) from pair-distance ratios
        of the two keyframes' stored landmarks over matched slots: every
        index pair (k, l) gives |X_i_k - X_i_l| / |X_j_k - X_j_l|, whatever
        the rigid drift between the epochs; the median over all pairs.
        None when fewer than ``min_pts`` matched slots have live landmarks
        on BOTH sides."""
        sys_ = self._sys
        tid_j = kf_j.track_ids
        ok = (midx >= 0) & (tid_j >= 0)
        tid_i = np.where(ok, kf_i.track_ids[np.maximum(midx, 0)], -1)
        ok &= tid_i >= 0
        ok &= sys_.track_alive[np.maximum(tid_j, 0)]
        ok &= sys_.track_alive[np.maximum(tid_i, 0)]
        sel = np.nonzero(ok)[0]
        if sel.size < min_pts:
            return None
        X_j = sys_.track_positions[tid_j[sel]]
        X_i = sys_.track_positions[tid_i[sel]]
        d_j = np.linalg.norm(X_j[:, None] - X_j[None, :], axis=-1)
        d_i = np.linalg.norm(X_i[:, None] - X_i[None, :], axis=-1)
        iu = np.triu_indices(sel.size, k=1)
        dj, di = d_j[iu], d_i[iu]
        good = dj > 1e-6
        if int(good.sum()) < min_pts:
            return None
        s = float(np.median(di[good] / dj[good]))
        return s if np.isfinite(s) and 1e-4 < s < 1e4 else None

    def scale_vs_unit(self, kf, pts_unit, pv, pose, slot_map=None):
        """Median ratio of the keyframe's known landmark depths to the
        unit-baseline triangulated depths (both in the keyframe's camera).
        ``slot_map`` maps triangulation slots (frame A) to this keyframe's
        slots (the B side of the pair).  None when fewer than 5 re-observed
        tracks support the estimate."""
        sys_ = self._sys
        slots = slot_map if slot_map is not None else np.arange(len(kf.track_ids))
        ids = kf.track_ids[np.maximum(slots, 0)]
        has = (slots >= 0) & (ids >= 0) & sys_.track_alive[np.maximum(ids, 0)]
        world = sys_.track_positions[np.maximum(ids, 0)]
        d_world = (world @ pose[:, :3].T + pose[:, 3])[:, 2]
        d_unit = pts_unit[:, 2]
        ok = has & np.asarray(pv, bool) & (d_unit > 1e-3) & (d_world > 1e-3)
        if ok.sum() < 5:
            return None
        return float(np.median(d_world[ok] / d_unit[ok]))

    def apply_sim3_correction(self, scale: np.ndarray, poses: np.ndarray,
                              old_poses: np.ndarray | None = None):
        """Write back the optimised Sim(3) nodes: keyframe k's SE(3) pose
        becomes (R_k, t_k / s_k), and each landmark moves through its last
        observing keyframe's correction p' = S_new^-1(S_old(p)), which
        keeps its projection in that keyframe.  ``old_poses``: the poses
        before the solve, one stacked fetch when not given; the new poses
        go up in one copy."""
        sys_ = self._sys
        if old_poses is None:
            old_poses = sys_.poses()
        last_kf = np.full(sys_.track_positions.shape[0], -1, np.int64)
        for k, kf in enumerate(sys_.keyframes):
            ids = kf.track_ids
            last_kf[ids[ids >= 0]] = k
        tids = np.nonzero((last_kf >= 0) & sys_.track_alive)[0]
        if tids.size:
            ks = last_kf[tids]
            p = sys_.track_positions[tids]
            To = old_poses[ks]
            p_cam = np.einsum("nij,nj->ni", To[:, :, :3], p) + To[:, :, 3]
            Tn = poses[ks]
            s = scale[ks]
            q = p_cam - Tn[:, :, 3]
            p_new = np.einsum("nji,nj->ni", Tn[:, :, :3], q) / s[:, None]
            sys_.track_positions[tids] = p_new.astype(np.float32)
        corr = poses.copy()
        corr[:, :, 3] /= scale[:, None]
        _set_poses(sys_, corr)

    def loop_edge_consistency(self, poses: np.ndarray) -> float | None:
        """Mean per-edge inconsistency of the last APPLIED loop edges
        against ``poses`` (host math): squared relative-translation gap,
        normalised by the MAP scale (mean squared camera-centre spread).
        None when no applied closure exists.

        Loop edges join spatially nearby keyframes, so normalising by an
        edge's own baseline would blow up on exactly the edges that matter;
        in units of the map, a benign global-BA nudge reads ~1e-4 and a
        catastrophic solve ~3e-2.  Loop edges are measurements independent
        of the reprojection problem, so an optimisation that lowers the
        robust cost while blowing this up is fitting observation noise at
        the expense of global structure."""
        if self.last_loop_edges is None:
            return None
        ei, ej, es, eT = self.last_loop_edges
        if not ei:
            return None
        centers = np.stack([-(P[:, :3].T @ P[:, 3]) for P in poses])
        s2 = max(float(np.mean(np.sum((centers - centers.mean(0)) ** 2, axis=-1))), 1e-12)
        tot = 0.0
        for i, j, s, T in zip(ei, ej, es, eT):
            Ti, Tj = poses[i], poses[j]
            Rp = Ti[:, :3] @ Tj[:, :3].T
            tp = Ti[:, 3] - Rp @ Tj[:, 3]
            tot += float(np.sum((T[:, 3] - tp) ** 2)) / s2
            # (no log-scale term: an edge's relative scale does not depend
            # on the poses, so it would only dilute a before/after ratio)
        return tot / len(ei)

    # ------------------------------------------------------------------
    # Finalisation: closure <-> global BA alternation, monotone
    # ------------------------------------------------------------------
    def snapshot_map(self) -> dict:
        """Copy everything a finalize round can change: keyframe poses (one
        stacked fetch), landmark positions, liveness."""
        sys_ = self._sys
        return {
            "poses": sys_.poses(),
            "track_positions": sys_.track_positions.copy(),
            "track_alive": sys_.track_alive.copy(),
            "num_kf": len(sys_.keyframes),
        }

    def restore_map(self, snap: dict) -> None:
        """Roll keyframe poses and landmarks back to a snapshot.  Keyframes
        appended after it (none during finalize) keep their poses."""
        sys_ = self._sys
        _set_poses(sys_, snap["poses"][: snap["num_kf"]])
        sys_.track_positions = snap["track_positions"]
        sys_.track_alive = snap["track_alive"]

    def finalize(self, rounds: int = 3) -> dict:
        """Alternate Sim(3) loop closure and global bundle adjustment,
        never leaving the map worse than a previous round.

        A closure pass estimates each loop edge's scale from the CURRENT
        map and the correction improves that map, so re-closing converges
        further.  Each round's re-detected graph initial cost c0 measures,
        without ground truth, how consistent the PREVIOUS round left the
        map; the map is snapshotted at every round's entry, and when c0
        rises (``cost_rose``), or when the previous round built edges and
        this one builds none from its candidates (``build_collapsed``),
        the previous round's entry snapshot is restored and the loop stops.
        Also stops when a round applies no edge and global BA is rejected,
        or when c0 converges.  Returns the rounds' stats."""
        sys_ = self._sys
        stats: list = []
        prev_c0 = None
        prev_built = None
        prev_snap = None  # the map at the entry of the PREVIOUS round
        for _ in range(rounds):
            snap = self.snapshot_map()
            edges = self.close_loops()
            c0 = float(self.last_stages.get("pg_cost", [np.inf])[0])
            built = int(self.last_stages.get("loop_edges_built", 0))
            cost_rose = (prev_c0 is not None and np.isfinite(c0) and np.isfinite(prev_c0)
                         and c0 > 1.02 * prev_c0)
            build_collapsed = (prev_snap is not None and prev_built is not None
                               and prev_built > 0 and built == 0
                               and int(self.last_stages.get("loop_candidates", 0)) > 0)
            if cost_rose or build_collapsed:
                self.restore_map(prev_snap)
                stats.append({
                    "loop_edges": int(edges),
                    "global_ba": False,
                    "graph_cost0": round(c0, 3),
                    "rolled_back": True,
                    "rollback_reason": "cost_rose" if cost_rose else "build_collapsed",
                })
                break
            applied = sys_.global_ba()
            stats.append({
                "loop_edges": int(edges),
                "global_ba": bool(applied),
                "graph_cost0": round(c0, 3),
            })
            if edges == 0 and not applied:
                break
            if edges == 0 and prev_c0 is not None and abs(c0 - prev_c0) < 0.1 * prev_c0:
                # Gate-rejected and the re-detected graph is unchanged:
                # more rounds would reject the same edges.
                break
            # Converged: when c0 stops dropping, more alternation only
            # re-fits measurement noise.
            per_edge = c0 / max(float(sys_.config.loop_weight) * max(edges, 1), 1e-9)
            if per_edge < 1.0:
                break
            if prev_c0 is not None and not (c0 < 0.9 * prev_c0):
                break
            prev_c0 = c0
            prev_built = built
            prev_snap = snap
        return {"rounds": stats}
