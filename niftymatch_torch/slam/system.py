"""Keyframe monocular SLAM system, the tracking half of ``slam/system.py``
of the JAX package.

The per-frame geometry is device work (detection with K2/K3, matching with
K1, E/H-RANSAC, triangulation, window BA); the bookkeeping (keyframe list,
track ids, window assembly) is host numpy.  The host waits on the device
once per chunk of frames (``process_frames``, ``process_features_batch``:
one batched fetch of the chunk's results) or once per frame
(``process_features``), plus once per relocalisation stage; the window
BA's accept/reject stays on the device and its landmarks ride the next
fetch.

Pipeline per frame: detect -> match against the last keyframe -> E/H
RANSAC -> cheirality pose -> monocular scale (median depth ratio of
re-observed landmarks) -> triangulation -> track-id propagation ->
(every ``ba_every`` keyframes) sliding-window BA.  After ``reloc_after``
rejected frames the relocaliser (``reloc.py``) queries older keyframes.

Loop closure (``closure.py``, ``closer``): an all-pairs sweep of the
keyframes' match counts proposes candidate pairs, verified closures become
Sim(3) pose-graph edges, and the optimised graph redistributes the drift;
``finalize`` alternates closure with global BA.

The RANSAC draw: one (scores_e, scores_h) pair serves every frame and
every relocalisation verify (the JAX package reuses the draw of
``jax.random.key(seed)`` on every frame, for both models); pass it as
``scores``, or the system draws it once from ``config.ransac.seed``.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..config import BAConfig, RansacConfig, SiftConfig
from ..features import Features
from ..ops.warp import remap, undistort_map
from ..sfm.ba import BAProblem, bundle_adjust
from ..sfm.se3 import se3_identity
from ..sift import detect_and_describe, detect_and_describe_batch
from ..utils.precision import device_constant, host_fetch, resolve_device
from .closure import LoopCloser
from .frontend import _draw_pair, slam_chunk, slam_step
from .globalba import run_global_ba
from .keyframe import Keyframe
from .reloc import Relocalizer
from .store import FeatureStore


@dataclasses.dataclass
class SlamConfig:
    """The JAX package's ``SlamConfig``, field for field."""

    width: int = 640
    height: int = 480
    intrinsics: tuple = (525.0, 525.0, 320.0, 240.0)  # fx, fy, cx, cy
    distortion: tuple | None = None  # (k1, k2, k3) radial; None = rectified
    ransac: RansacConfig = dataclasses.field(
        default_factory=lambda: RansacConfig(iterations=1024, inlier_threshold=4.0))
    ba: BAConfig = dataclasses.field(
        default_factory=lambda: BAConfig(max_iterations=8, damping=1e-3))
    min_inliers: int = 15
    ba_window: int = 5          # keyframes per BA window
    ba_every: int = 3           # run windowed BA every k keyframes
    max_tracks: int = 4096      # initial landmark capacity (host arrays grow)
    max_obs: int = 8192         # BA observation capacity (fixed shape)
    ba_landmarks_cap: int = 1024  # window-BA landmark capacity (fixed shape)
    detector_features: int = 1024
    # Loop closure: candidate pairs need >= loop_min_matches mutual matches
    # between keyframes >= loop_min_gap apart; verified closures enter the
    # pose graph with loop_weight against 1.0 for odometry.  Candidates are
    # verified loop_verify_batch at a time, at most max_loop_candidates.
    loop_min_gap: int = 3
    loop_min_matches: int = 50
    loop_weight: float = 10.0
    loop_verify_batch: int = 32
    max_loop_candidates: int = 96
    # Relocalisation after reloc_after consecutive rejected frames, against
    # the last reloc_window keyframes and a sample of older ones.
    reloc_after: int = 2
    reloc_window: int = 6
    # Temporal non-max suppression of loop candidates on the (i, j) grid
    # before verification, and the cap on loop edges (the best-verified)
    # after it; 0 disables either.
    loop_candidate_nms: int = 2
    loop_max_edges: int = 32
    # Re-observed tracks keep their stored (BA-refined) positions instead
    # of this frame's triangulation (False: chain fresh triangulations).
    anchor_landmarks: bool = True
    chunk_size: int = 8         # frames per chunk in process_frames
    store_capacity: int = 64    # initial FeatureStore capacity (keyframes)


class SlamSystem:
    """Host-orchestrated keyframe SLAM over device steps, on ``device``
    (CUDA by default).  ``scores``: the (scores_e, scores_h) RANSAC draws,
    each (config.ransac.iterations, detector capacity)."""

    def __init__(self, config: SlamConfig, device=None, scores=None):
        self.config = config
        self.device = resolve_device(device)
        self.intrinsics = tuple(float(v) for v in config.intrinsics)
        self._sift = SiftConfig(width=config.width, height=config.height,
                                max_features=config.detector_features)
        self._undist = None
        if config.distortion is not None:
            self._undist = undistort_map(
                device_constant(self.intrinsics, self.device, torch.float32),
                device_constant(config.distortion, self.device, torch.float32),
                config.height, config.width)
        self._scores = None if scores is None else _draw_pair(
            scores, config.ransac, 0, self.device)
        self._store = FeatureStore(init_capacity=config.store_capacity,
                                   chunk_pad=config.chunk_size)
        # In-flight window-BA landmark update, harvested by the next fetch.
        self._pending_ba = None
        self.keyframes: List[Keyframe] = []
        # Global track store (host bookkeeping).
        self._next_track = 0
        self.track_positions = np.zeros((config.max_tracks, 3), np.float32)
        self.track_alive = np.zeros((config.max_tracks,), bool)
        self._frames_since_ba = 0
        self.closer = LoopCloser(self)
        self.reloc = Relocalizer(self)

    def scores(self, feats: Features):
        """The RANSAC draw pair for frames of ``feats``' capacity: the one
        given, or one draw from ``config.ransac.seed`` made on first use."""
        if self._scores is None:
            self._scores = _draw_pair(None, self.config.ransac, feats.x.shape[-1],
                                      self.device)
        return self._scores

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------
    def _images(self, frames) -> torch.Tensor:
        """(B, H, W) frames (uint8 stays uint8 on the upload) as float32 on
        the device, undistorted when the config has distortion."""
        imgs = torch.as_tensor(frames).to(self.device, non_blocking=True)
        imgs = imgs.to(torch.float32)
        if self._undist is not None:
            imgs = remap(imgs.permute(1, 2, 0), *self._undist).permute(2, 0, 1)
        return imgs

    def process_frame(self, image) -> dict:
        """Ingest one grayscale frame; returns per-frame status."""
        frame = self._images(torch.as_tensor(image)[None])[0]
        return self.process_features(detect_and_describe(frame, self._sift, device=self.device))

    def process_frames(self, frames, chunk: int | None = None) -> List[dict]:
        """Ingest N grayscale frames in chunks of ``chunk_size``: per chunk
        one upload, one batched detection (K2 and K3 once), ``slam_chunk``
        and one batched fetch.  A short last chunk is not padded: nothing
        is compiled for a shape, so the JAX package's padding would only
        add frames to run."""
        chunk = chunk or self.config.chunk_size
        frames = np.asarray(frames)
        if frames.dtype != np.uint8:
            frames = frames.astype(np.float32, copy=False)
        results: List[dict] = []
        start = 0
        if not self.keyframes:
            feats0 = detect_and_describe(self._images(frames[:1])[0], self._sift,
                                         device=self.device)
            results.append(self._first_keyframe(feats0))
            start = 1
        while start < len(frames):
            batch = frames[start:start + chunk]
            feats_b = detect_and_describe_batch(self._images(batch), self._sift,
                                                device=self.device)
            results.extend(self._chunk(feats_b))
            start += len(batch)
        return results

    def process_features_batch(self, feats_batch: Features) -> List[dict]:
        """Chunked ingest of pre-detected features (a leading batch axis on
        every field): the feature-level twin of :meth:`process_frames`.
        The JAX package's ``n_real`` (rows beyond it are padding) has no
        counterpart: nothing here is padded."""
        feats_batch = Features(*[device_constant(a, self.device) for a in feats_batch])
        results: List[dict] = []
        if not self.keyframes:
            results.append(self._first_keyframe(Features(*[a[0] for a in feats_batch])))
            feats_batch = Features(*[a[1:] for a in feats_batch])
            if feats_batch.x.shape[0] == 0:
                return results
        results.extend(self._chunk(feats_batch))
        return results

    def _first_keyframe(self, feats: Features) -> dict:
        self.keyframes.append(Keyframe(
            index=0, feats=feats, pose=se3_identity(device=self.device).clone(),
            track_ids=np.full((feats.x.shape[-1],), -1, np.int64),
            store=self._store, slot=self._store.stage_single(feats)))
        return {"keyframe": True, "num_inliers": 0, "tracked": 0}

    def _context(self, kf: Keyframe):
        """The stored landmark positions (N, 3) and liveness (N,) at
        ``kf``'s slots, uploaded without a wait."""
        ids = kf.track_ids
        has = (ids >= 0) & self.track_alive[np.maximum(ids, 0)]
        world = self.track_positions[np.maximum(ids, 0)]
        return device_constant(world, self.device), device_constant(has, self.device)

    def _chunk(self, feats_b: Features) -> List[dict]:
        """``slam_chunk`` over the rows of ``feats_b`` against the last
        keyframe, then the host bookkeeping."""
        last = self.keyframes[-1]
        outs, accepts = slam_chunk(
            last.feats, feats_b, last.pose, *self._context(last), self.intrinsics,
            self.config.ransac, self.config.min_inliers,
            anchor_landmarks=self.config.anchor_landmarks,
            scores=self.scores(feats_b), device=self.device)
        return self._absorb_chunk(feats_b, outs, accepts)

    def _absorb_chunk(self, feats_b, outs, accepts) -> List[dict]:
        """Host bookkeeping for one processed chunk: ONE batched fetch, then
        per-frame track propagation and keyframe creation in numpy.
        Accepted frames' features are staged into the store and written at
        its next flush, after which nothing references the chunk batch."""
        pending, self._pending_ba = self._pending_ba, None
        host = host_fetch(accepts, outs.num_inliers, outs.indices, outs.inliers,
                          outs.points_w, outs.points_valid, feats_b.x, feats_b.y,
                          *((pending[0],) if pending is not None else ()))
        if pending is not None:
            active = pending[2]
            self.track_positions[active] = host[8][: len(active)]
        acc, ninl, m_idx, inl, pts_w, valid_w, xs, ys = host[:8]
        results: List[dict] = []
        acc_rows: List[int] = []   # chunk rows accepted as keyframes
        acc_kfs: List[Keyframe] = []

        def commit_rows():
            if acc_rows:
                slots = self._store.stage_chunk(feats_b, acc_rows)
                for kf_, slot_ in zip(acc_kfs, slots):
                    kf_.slot = slot_
                acc_rows.clear()
                acc_kfs.clear()

        n = len(acc)
        for i in range(n):
            if not bool(acc[i]):
                self.reloc.note_miss()
                if self.reloc.due():
                    commit_rows()
                    info = self.reloc.maybe_relocalize(Features(*[a[i] for a in feats_b]))
                    if info is not None:
                        results.append(info)
                        # The rest of this chunk tracked the old keyframe
                        # carry: run it again against the new anchor.
                        if i + 1 < n:
                            rest = Features(*[a[i + 1:] for a in feats_b])
                            results.extend(self.process_features_batch(rest))
                        return results
                results.append({"keyframe": False, "num_inliers": int(ninl[i]), "tracked": 0})
                continue
            self.reloc.reset()
            last = self.keyframes[-1]
            kf = Keyframe(
                index=len(self.keyframes),
                store=self._store,
                slot=-1,  # assigned by commit_rows()
                pose=outs.pose[i],
                track_ids=np.full((xs.shape[1],), -1, np.int64),
                host_x=xs[i],
                host_y=ys[i],
            )
            acc_rows.append(i)
            acc_kfs.append(kf)
            tracked = self._propagate_tracks(last, kf, m_idx=m_idx[i], inl=inl[i],
                                             pts_w=pts_w[i], valid_w=valid_w[i])
            self.keyframes.append(kf)
            results.append({"keyframe": True, "num_inliers": int(ninl[i]),
                            "tracked": tracked})
            self._frames_since_ba += 1
        commit_rows()
        if self._frames_since_ba >= self.config.ba_every and len(self.keyframes) >= 3:
            self.run_windowed_ba()
            self._frames_since_ba = 0
        return results

    def process_features(self, feats: Features) -> dict:
        """Ingest one pre-detected feature set (an external detector, the
        synthetic track generator): one ``slam_step``, one fetch."""
        feats = Features(*[device_constant(a, self.device) for a in feats])
        if not self.keyframes:
            return self._first_keyframe(feats)
        last = self.keyframes[-1]
        out = slam_step(last.feats, feats, last.pose, *self._context(last), self.intrinsics,
                        self.config.ransac, scores=self.scores(feats), device=self.device)
        pending, self._pending_ba = self._pending_ba, None
        host = host_fetch(out.success, out.num_inliers, out.indices, out.inliers,
                          out.points_w, out.points_valid, feats.x, feats.y,
                          *((pending[0],) if pending is not None else ()))
        if pending is not None:
            active = pending[2]
            self.track_positions[active] = host[8][: len(active)]
        success, num_inl = bool(host[0]), int(host[1])
        if not success or num_inl < self.config.min_inliers:
            self.reloc.note_miss()
            if self.reloc.due():
                info = self.reloc.maybe_relocalize(feats)
                if info is not None:
                    return info
            return {"keyframe": False, "num_inliers": num_inl, "tracked": 0}
        self.reloc.reset()
        kf = Keyframe(
            index=len(self.keyframes),
            feats=feats,
            pose=out.pose,
            track_ids=np.full((feats.x.shape[0],), -1, np.int64),
            host_x=host[6],
            host_y=host[7],
            store=self._store,
            slot=self._store.stage_single(feats),
        )
        tracked = self._propagate_tracks(last, kf, m_idx=host[2], inl=host[3],
                                         pts_w=host[4], valid_w=host[5])
        self.keyframes.append(kf)
        self._frames_since_ba += 1
        if self._frames_since_ba >= self.config.ba_every and len(self.keyframes) >= 3:
            self.run_windowed_ba()
            self._frames_since_ba = 0
        return {"keyframe": True, "num_inliers": num_inl, "tracked": tracked}

    def trajectory(self) -> np.ndarray:
        """(K, 3) camera centres of all keyframes."""
        poses = self.poses()
        R, t = poses[:, :, :3], poses[:, :, 3]
        return -np.einsum("kji,kj->ki", R, t)

    def poses(self) -> np.ndarray:
        """(K, 3, 4) keyframe poses: one stack and one fetch."""
        self.flush_ba()
        (poses,) = host_fetch(torch.stack([kf.pose for kf in self.keyframes]))
        return poses

    def prewarm_reloc(self) -> None:
        """See :meth:`.reloc.Relocalizer.prewarm`."""
        self.reloc.prewarm()

    def _ensure_track_capacity(self, need: int) -> None:
        """Double the host track arrays when the id space fills up, so long
        sequences keep minting tracks."""
        cap = self.track_positions.shape[0]
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        grow = cap - self.track_positions.shape[0]
        self.track_positions = np.concatenate(
            [self.track_positions, np.zeros((grow, 3), np.float32)])
        self.track_alive = np.concatenate([self.track_alive, np.zeros((grow,), bool)])

    def _propagate_tracks(self, last: Keyframe, kf: Keyframe, *, m_idx, inl, pts_w,
                          valid_w) -> int:
        """Assign track ids to the new keyframe's slots from the step's
        (already fetched) triangulation; numpy only.  With
        ``anchor_landmarks`` an existing track keeps its stored position
        and only new tracks take this frame's triangulation."""
        anchor = self.config.anchor_landmarks
        has_old = last.track_ids >= 0
        keep_mask = (valid_w | has_old) if anchor else valid_w
        sel = np.nonzero(inl & (m_idx >= 0) & keep_mask)[0]
        if sel.size == 0:
            return 0
        tids = last.track_ids[sel].copy()
        # Mint new track ids for slots without one (capacity-bounded).
        need = np.nonzero(tids < 0)[0]
        self._ensure_track_capacity(self._next_track + len(need))
        n_new = min(len(need), self.track_positions.shape[0] - self._next_track)
        minted = np.zeros_like(tids, bool)
        if n_new > 0:
            tids[need[:n_new]] = np.arange(self._next_track, self._next_track + n_new,
                                           dtype=np.int64)
            minted[need[:n_new]] = True
            self._next_track += n_new
        keep = tids >= 0
        sel, tids, minted = sel[keep], tids[keep], minted[keep]
        last.track_ids[sel] = tids
        kf.track_ids[m_idx[sel]] = tids
        if anchor:
            self.track_positions[tids[minted]] = pts_w[sel[minted]]
        else:
            fresh = valid_w[sel]
            self.track_positions[tids[fresh]] = pts_w[sel[fresh]]
        self.track_alive[tids] = True
        return int(sel.size)

    def _window_problem(self, window: List[Keyframe]):
        """A fixed-capacity window BA problem: the window's poses and ONE
        float32 buffer (uploaded without a wait) packing, in order, the
        observations' uv, camera, landmark and valid flag (``max_obs``
        rows), the landmarks (``ba_landmarks_cap``) and the fixed-pose mask.
        Returns ((poses, buf), active track ids, window) or Nones."""
        C = len(window)
        cfg = self.config
        ids = np.stack([kf.track_ids for kf in window])  # (C, N)
        has = ids >= 0
        if not has.any():
            return None, None, None
        counts = np.bincount(ids[has], minlength=self.track_positions.shape[0])
        active = np.nonzero(counts >= 2)[0]
        if len(active) < 8:
            return None, None, None
        if len(active) > cfg.ba_landmarks_cap:
            # Keep the most-observed tracks.
            order = np.argsort(-counts[active], kind="stable")
            active = np.sort(active[order[: cfg.ba_landmarks_cap]])
        L_cap = cfg.ba_landmarks_cap
        lmap = np.full(self.track_positions.shape[0], -1, np.int64)
        lmap[active] = np.arange(len(active))
        for kf in window:
            kf.ensure_host_coords()
        xs = np.stack([kf.host_x for kf in window])
        ys = np.stack([kf.host_y for kf in window])
        local = np.where(has, lmap[np.maximum(ids, 0)], -1)
        ci, si = np.nonzero(local >= 0)
        O = len(ci)
        if O < 16:
            return None, None, None
        O_cap = cfg.max_obs
        if O > O_cap:
            ci, si = ci[:O_cap], si[:O_cap]
            O = O_cap
        buf = np.zeros(5 * O_cap + 3 * L_cap + C, np.float32)
        uv = buf[: 2 * O_cap].reshape(O_cap, 2)
        uv[:O, 0] = xs[ci, si]
        uv[:O, 1] = ys[ci, si]
        buf[2 * O_cap: 2 * O_cap + O] = ci
        buf[3 * O_cap: 3 * O_cap + O] = local[ci, si]
        buf[4 * O_cap: 4 * O_cap + O] = 1.0
        lms = buf[5 * O_cap: 5 * O_cap + 3 * L_cap].reshape(L_cap, 3)
        lms[: len(active)] = self.track_positions[active]
        fixed = buf[5 * O_cap + 3 * L_cap:]
        fixed[0] = 1.0
        if C > 1:
            fixed[1] = 1.0  # pin the 7-DoF monocular gauge
        poses = [kf.pose for kf in window]
        return (poses, device_constant(buf, self.device)), active, window

    def _ba_gated(self, pose_list, buf):
        """Window BA on the packed problem with the accept on the device: a
        solve that does not lower the cost gives back its input, so the
        host never waits on it."""
        O_cap, L_cap = self.config.max_obs, self.config.ba_landmarks_cap
        o2, o3, o4, o5 = 2 * O_cap, 3 * O_cap, 4 * O_cap, 5 * O_cap
        poses = torch.stack(pose_list)
        C = poses.shape[0]
        p = BAProblem(
            poses=poses,
            landmarks=buf[o5: o5 + 3 * L_cap].reshape(L_cap, 3),
            intrinsics=device_constant(self.intrinsics, self.device, torch.float32),
            obs_uv=buf[:o2].reshape(O_cap, 2),
            obs_cam=buf[o2:o3].to(torch.int32),
            obs_lm=buf[o3:o4].to(torch.int32),
            obs_valid=buf[o4:o5] > 0.5,
            pose_fixed=buf[o5 + 3 * L_cap: o5 + 3 * L_cap + C] > 0.5,
        )
        solved, stats = bundle_adjust(p, self.config.ba, device=self.device)
        improved = stats.final_cost <= stats.initial_cost
        out_poses = torch.where(improved, solved.poses, p.poses)
        lms = torch.where(improved, solved.landmarks, p.landmarks)
        return out_poses, lms, stats

    # ------------------------------------------------------------------
    # Loop closure and finalisation (closure.py, globalba.py)
    # ------------------------------------------------------------------
    @property
    def last_closure_stages(self) -> dict:
        """Per-stage seconds and diagnostics of the latest
        :meth:`close_loops`."""
        return self.closer.last_stages

    def match_keyframes(self, pairs) -> np.ndarray:
        """Mutual ratio-test match indices for keyframe index pairs (see
        :meth:`.closure.LoopCloser.match_keyframes`)."""
        return self.closer.match_keyframes(pairs)

    def detect_loop_candidates(self, return_matches: bool = False):
        """Candidate loop pairs from the all-pairs sweep (see
        :meth:`.closure.LoopCloser.detect_candidates`)."""
        return self.closer.detect_candidates(return_matches)

    def close_loops(self) -> int:
        """One loop-closure pass (see
        :meth:`.closure.LoopCloser.close_loops`)."""
        return self.closer.close_loops()

    def finalize(self, rounds: int = 3) -> dict:
        """Monotone closure <-> global-BA alternation (see
        :meth:`.closure.LoopCloser.finalize`)."""
        return self.closer.finalize(rounds)

    def global_ba(self, ba_config: BAConfig | None = None, use_cg: bool | None = None,
                  max_landmarks: int | None = None) -> bool:
        """Full-trajectory bundle adjustment (see
        :func:`.globalba.run_global_ba`)."""
        return run_global_ba(self, ba_config=ba_config, use_cg=use_cg,
                             max_landmarks=max_landmarks)

    def run_windowed_ba(self, block: bool = False) -> bool:
        """Optimise the last ``ba_window`` keyframes and their tracks.

        Fire-and-forget: the window's poses become views of the gated
        result on the device, and the landmarks ride the NEXT fetch.  Pass
        ``block=True`` (or call :meth:`flush_ba`) to harvest them now."""
        self.flush_ba()  # at most one solve in flight; seeds must be current
        problem, active, window = self._window_problem(self.keyframes[-self.config.ba_window:])
        if problem is None:
            return False
        poses, lms, stats = self._ba_gated(*problem)
        for ci, kf in enumerate(window):
            kf.pose = poses[ci]
        self._pending_ba = (lms, stats, active)
        if block:
            self.flush_ba()
        return True

    def flush_ba(self) -> None:
        """Harvest an in-flight window-BA landmark update, if any."""
        if self._pending_ba is None:
            return
        lms, _, active = self._pending_ba
        self._pending_ba = None
        (lms_h,) = host_fetch(lms)
        self.track_positions[active] = lms_h[: len(active)]
