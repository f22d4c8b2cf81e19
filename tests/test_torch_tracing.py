"""The port's tracing (``niftymatch_torch/utils/profiling.py``'s gated
``annotate``, ``count`` and ``counts``, and the ``nm.slam.*`` regions of the
SLAM tracking loop) on the CPU.

A ``process_features_batch`` session on ``make_feature_sequence`` of 8
cameras, 400 landmarks and 384 slots (``tests/test_torch_slam.py``'s), in
chunks of 1 + 3, 1 and 3 frames with window BA every 3 keyframes (at the
first and the last chunk's end; the first solve's landmarks ride the
second chunk's fetch, the last one's a ``flush_ba``), runs once with no
profiler and once under ``profiling.trace``.  The traced run must hold
the tracking loop's regions, properly nested, and answer exactly as the
untraced one; the window-BA counters must agree with the solves' own
observation counts, and the small-matrix solvers' counters count every
call and, on the CPU, no fused one.  The SIFT, pair-matching and all-pairs entry points
must open none of the program's regions: the benchmark's per-layer
metrics of the other cells attribute device work to the innermost region,
and a region of the program inside those calls would take it from them.
"""

import json

import numpy as np
import pytest
import torch

import niftymatch_torch.data.synthetic as tsyn
from niftymatch_torch import SiftConfig, detect_and_describe_batch, match_pair
from niftymatch_torch.config import RansacConfig
from niftymatch_torch.features import Features
from niftymatch_torch.parallel.matching import allpairs_match_fused
from niftymatch_torch.slam import SlamConfig, SlamSystem
from niftymatch_torch.utils import profiling

CAP, ITERS = 384, 512
CHUNKS = ((0, 4), (4, 5), (5, 8))
FRAME_STAGES = ("match", "ransac_e", "ransac_h", "select", "scale_tri", "carry")
SELECT_STAGES = [f"nm.slam.frame.select.{s}" for s in ("pose_e", "refine", "pose_e", "pose_h")]
IN_A_FRAME = sorted([f"nm.slam.frame.{s}" for s in FRAME_STAGES] + SELECT_STAGES)
# The regions a process_features_batch session reaches, flush_ba included.
SESSION_SPANS = {"nm.slam.chunk", "nm.slam.frame", "nm.slam.fetch", "nm.slam.absorb",
                 "nm.slam.window_ba.pack", "nm.slam.window_ba.solve", "nm.slam.ba_fetch",
                 *IN_A_FRAME}


@pytest.fixture(scope="module")
def feats():
    scene = tsyn.make_scene(num_cams=8, num_landmarks=400, seed=0, radius=6.0,
                            width=640, height=480)
    return scene, tsyn.make_feature_sequence(scene, capacity=CAP, noise_px=0.5, seed=0)


def _session(scene, tf, solves=None):
    """Keyframe flags, inlier counts and poses of one chunked session;
    ``solves`` collects each window-BA solve's real observations."""
    intr = tuple(float(v) for v in scene.intrinsics)
    cfg = SlamConfig(width=640, height=480, intrinsics=intr, detector_features=CAP,
                     ransac=RansacConfig(ITERS, 4.0), ba_every=3, ba_window=4)
    system = SlamSystem(cfg, device="cpu")
    if solves is not None:
        gated = system._ba_gated

        def observed(pose_list, buf, n_obs):
            O_cap = cfg.max_obs
            solves.append(int(buf[4 * O_cap: 5 * O_cap].sum()))
            return gated(pose_list, buf, n_obs)

        system._ba_gated = observed
    infos = []
    for a, b in CHUNKS:
        infos += system.process_features_batch(
            Features(*[torch.stack(x) for x in zip(*tf[a:b])]))
    system.flush_ba()
    return ([i["keyframe"] for i in infos], [i["num_inliers"] for i in infos],
            np.stack([kf.pose.numpy() for kf in system.keyframes]), cfg)


@pytest.fixture(scope="module")
def sessions(feats, tmp_path_factory):
    """(untraced, traced) sessions, the traced one's solves, counters and
    spans [(name, start_us, end_us)] in start order."""
    scene, tf = feats
    plain = _session(scene, tf)
    logdir = tmp_path_factory.mktemp("trace")
    solves = []
    with profiling.trace(str(logdir)):
        traced = _session(scene, tf, solves)
        counted = profiling.counts()
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    spans = sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") == "user_annotation" and e["name"].startswith("nm.")),
                   key=lambda s: s[1])
    return plain, traced, solves, counted, logdir, spans


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_traced_session_holds_the_tracking_spans(sessions):
    *_, spans = sessions
    names = {s[0] for s in spans}
    assert names == SESSION_SPANS
    frames = [s for s in spans if s[0] == "nm.slam.frame"]
    assert len(frames) == 8 - 1   # every frame fed after the first
    chunks = [s for s in spans if s[0] == "nm.slam.chunk"]
    assert len(chunks) == len(CHUNKS)
    for f in frames:
        assert sum(_inside(f, c) for c in chunks) == 1
        stages = [s for s in spans if s[0].startswith("nm.slam.frame.") and _inside(s, f)]
        assert sorted(s[0] for s in stages) == IN_A_FRAME
        select = next(s for s in stages if s[0] == "nm.slam.frame.select")
        assert [s[0] for s in stages if _inside(s, select) and s != select] == SELECT_STAGES
    for s in spans:
        if s[0].startswith("nm.slam.frame."):
            assert sum(_inside(s, f) for f in frames) == 1, s
    for name in ("nm.slam.fetch", "nm.slam.absorb", "nm.slam.window_ba.pack",
                 "nm.slam.window_ba.solve", "nm.slam.ba_fetch"):
        assert not any(_inside(s, c) for s in spans if s[0] == name for c in chunks), name


def test_gated_annotate_and_count_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    before = profiling.counts()
    assert profiling.annotate("nm.test") is profiling.annotate("nm.other")
    with profiling.annotate("nm.test") as ctx:
        assert ctx is None
    profiling.count("ba.solves")
    profiling.count("test.count", 5)
    assert profiling.counts() == before


def test_tracing_leaves_the_session_unchanged(sessions):
    (flags, inliers, poses, _), (flags_t, inliers_t, poses_t, _), *_ = sessions
    assert flags_t == flags and all(flags[1:])
    assert inliers_t == inliers
    np.testing.assert_array_equal(poses_t, poses)


def test_ba_counters_count_each_solve(sessions):
    _, (*_, cfg), solves, counted, logdir, _ = sessions
    assert len(solves) == 2 and all(0 < o < cfg.max_obs for o in solves)
    assert counted == {"ba.solves": len(solves),
                       "ba.obs_updates": sum(solves) * cfg.ba.max_iterations,
                       "refine.calls": 8 - 1,   # one polish a tracked frame, on the CPU
                       # 15 small-matrix solves a tracked frame (7 svd3x3: 4 in
                       # RANSAC-E, 1 in each recover_pose and in the homography's
                       # decomposition; 8 smallest_eigvec: the two 8-point and two
                       # DLT homography fits, 4 triangulate_dlt), none fused on the CPU
                       "linalg.calls": 15 * (8 - 1),
                       # the E and H RANSACs of a tracked frame, plain on the CPU
                       "ransac.calls": 2 * (8 - 1)}
    assert json.loads((logdir / "counters.json").read_text()) == counted


def test_entry_points_of_the_other_cells_open_no_program_span(tmp_path):
    rng = np.random.default_rng(0)
    cfg = SiftConfig(width=128, height=96, max_keypoints_per_level=64, max_features=128)
    imgs = torch.from_numpy(rng.uniform(0, 255, (3, 96, 128)).astype(np.float32))
    with profiling.trace(str(tmp_path)):
        fb = detect_and_describe_batch(imgs, cfg, device="cpu")
        one = [Features(*[a[i] for a in fb]) for i in range(2)]
        match_pair(one[0], one[1], device="cpu")
        allpairs_match_fused(fb.desc, fb.valid, ambiguity=0.8, mutual=True,
                             return_indices=True)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert not [e["name"] for e in events if e.get("name", "").startswith("nm.")]
    assert json.loads((tmp_path / "counters.json").read_text()) == {}
