"""Phase 10d of ``chip_smoke.py``: the dataset path on the card.

Phase 8b's rendered clip (640x480 uint8) is written to disk as a TUM
RGB-D directory (``png.write_png`` into ``rgb/``, ``rgb.txt``, and
``groundtruth.txt`` by ``tum.write_trajectory`` of the scene's camera
centres), read back with ``tum.load_sequence``, decoded by
``native_loader.PrefetchLoader`` and fed to ``SlamSystem.process_frames``
with 8b's config, draw and call boundaries (frames 0-32, then 16 a call,
then ``flush_ba``).  Bars: the poses equal 8b's in-memory run's within
1e-6 (PNG is lossless for uint8); the ATE from ``tum.associate`` of the
keyframes' timestamps with the groundtruth file and ``utils.metrics``
equal to 8b's within 1e-6.  The same frames written in EuRoC layout
(``mav0/cam0/data.csv``, ``sensor.yaml``) decode to the same arrays
through ``euroc.load_sequence``.  One short chunk runs under
``utils.profiling.trace``; the loader's frames/s is printed beside the
SLAM loop's.

Every failed check raises.  The native loader must build: a failed build
fails the phase.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np

FPS = 30.0
T0 = 1305031102.175304          # a TUM-like first timestamp (s)
TRACE_FRAMES = 2                # the traced chunk: frames 1-2 after frame 0


def write_tum(root, frames, poses):
    """A TUM RGB-D directory of ``frames`` (uint8) with the ground truth
    of world->camera ``poses``; returns the timestamps."""
    from ..data import png, tum

    os.makedirs(os.path.join(root, "rgb"))
    times = T0 + np.arange(len(frames)) / FPS
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write("# color images\n# timestamp filename\n")
        for t, img in zip(times, frames):
            name = f"rgb/{t:.6f}.png"
            png.write_png(os.path.join(root, name), img)
            f.write(f"{t:.6f} {name}\n")
    tum.write_trajectory(os.path.join(root, "groundtruth.txt"),
                         tum.poses_to_trajectory(poses.astype(np.float64), times))
    return times


def write_euroc(root, frames, times):
    """The same frames in EuRoC's ASL layout (cam0 and its sensor.yaml;
    the ground-truth file with identity attitudes)."""
    from ..data import png

    cam = os.path.join(root, "mav0", "cam0")
    os.makedirs(os.path.join(cam, "data"))
    gt = os.path.join(root, "mav0", "state_groundtruth_estimate0")
    os.makedirs(gt)
    ns = np.round(times * 1e9).astype(np.int64)
    with open(os.path.join(cam, "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        for t, img in zip(ns, frames):
            png.write_png(os.path.join(cam, "data", f"{t}.png"), img)
            f.write(f"{t},{t}.png\n")
    with open(os.path.join(cam, "sensor.yaml"), "w") as f:
        f.write("sensor_type: camera\nintrinsics: [525.0, 525.0, 320.0, 240.0]\n"
                "distortion_coefficients: [0.0, 0.0, 0.0, 0.0]\n")
    with open(os.path.join(gt, "data.csv"), "w") as f:
        f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], q_RS_w [], q_RS_x [], "
                "q_RS_y [], q_RS_z []\n")
        for t in ns:
            f.write(f"{t},0.0,0.0,0.0,1.0,0.0,0.0,0.0\n")


def _chunks(n, warm, size):
    """8b's call boundaries: frames [0, warm), then ``size`` a call."""
    return [(0, warm)] + [(a, min(a + size, n)) for a in range(warm, n, size)]


def run(dev, frames, scene, cfg, poses_8b, ate_8b, warmup):
    """Phase 10d against 8b's run (``poses_8b``, ``ate_8b``; 8b's first
    call held frames [0, ``warmup``)).  Returns (numbers, the kernels'
    launches of the dataset run)."""
    import niftymatch_torch as nt
    from niftymatch_torch.data import euroc, native_loader, tum
    from niftymatch_torch.kernels import _build
    from niftymatch_torch.utils import profiling
    from niftymatch_torch.utils.metrics import ate_rmse

    from .smoke_sfm import _sync

    assert native_loader.available(), "the native loader did not build"
    out = {"frames": len(frames)}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        times = write_tum(os.path.join(tmp, "tum"), frames, scene.poses)
        write_euroc(os.path.join(tmp, "euroc"), frames, times)
        out["write_s"] = time.perf_counter() - t0
        seq = tum.load_sequence(os.path.join(tmp, "tum"))
        assert len(seq.rgb_paths) == len(frames)

        # The loader alone: decoding rate.
        t0 = time.perf_counter()
        with native_loader.PrefetchLoader(seq.rgb_paths) as loader:
            decoded = np.stack(list(loader))
        out["loader_frames_per_s"] = len(frames) / (time.perf_counter() - t0)
        assert np.array_equal(decoded, frames.astype(np.float32)), "TUM decode differs"

        # The SLAM loop fed by the loader, 8b's call boundaries.
        slam = nt.SlamSystem(cfg, device=dev)
        _sync(dev)
        _build.reset_launches()
        t0 = time.perf_counter()
        infos = []
        with native_loader.PrefetchLoader(seq.rgb_paths) as loader:
            for a, b in _chunks(len(frames), warmup, cfg.chunk_size):
                infos += slam.process_frames(np.stack([next(loader) for _ in range(a, b)]))
        slam.flush_ba()
        _sync(dev)
        out["slam_s"] = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        out["slam_frames_per_s"] = len(frames) / out["slam_s"]
        pose_err = float(np.abs(slam.poses() - poses_8b).max())
        kept = [i for i, inf in enumerate(infos) if inf["keyframe"]]
        gt = tum.read_trajectory(os.path.join(tmp, "tum", "groundtruth.txt"))
        ia, ib = tum.associate(seq.rgb_times[kept], gt.timestamps)
        assert len(ia) == len(kept), "a keyframe found no groundtruth pose"
        ate = ate_rmse(slam.trajectory()[ia], gt.positions[ib])
        out.update(keyframes=len(kept), pose_max_diff_vs_8b=pose_err, ate=ate,
                   ate_8b=ate_8b, ate_diff=abs(ate - ate_8b), launches=launches)
        assert pose_err <= 1e-6, f"10d: poses {pose_err} from 8b's in-memory run"
        assert abs(ate - ate_8b) <= 1e-6, f"10d: ATE {ate} against 8b's {ate_8b}"
        for name in ("k1_match_top2", "k2_orientation_hist", "k3_descriptor"):
            assert launches[name] > 0 or dev.type != "cuda", \
                f"{name} did not run on the dataset path"

        es = euroc.load_sequence(os.path.join(tmp, "euroc"))
        eu = np.stack([native_loader.read_gray(p) for p in es.cam_paths])
        assert np.array_equal(eu, decoded), "EuRoC decode differs"
        assert np.allclose(es.cam_times, times, atol=1e-6) \
            and es.intrinsics == (525.0, 525.0, 320.0, 240.0)

        # One short chunk under the tracer.
        one = nt.SlamSystem(cfg, device=dev)
        one.process_frames(decoded[:1])
        _sync(dev)
        logdir = os.path.join(tmp, "trace")
        t0 = time.perf_counter()
        with profiling.trace(logdir):
            with profiling.annotate("slam_chunk"):
                one.process_frames(decoded[1:1 + TRACE_FRAMES])
            _sync(dev)
        out["trace_s"] = time.perf_counter() - t0
        out["trace_bytes"] = os.path.getsize(os.path.join(logdir, "trace.json"))
    print(f"[dataset] 10d {len(frames)} frames written as TUM and EuRoC directories in "
          f"{out['write_s']:.1f} s; TUM through PrefetchLoader into process_frames: poses "
          f"within {pose_err:.1e} of 8b's in-memory run, ATE {ate:.6f} (8b {ate_8b:.6f}, "
          f"diff {out['ate_diff']:.1e}) over {len(kept)} keyframes; EuRoC decodes the same "
          f"arrays; launches {launches}")
    print(f"[dataset] 10d loader alone {out['loader_frames_per_s']:.1f} frames/s against the "
          f"SLAM loop's {out['slam_frames_per_s']:.3f} frames/s fed by it (warm-up included); "
          f"a {TRACE_FRAMES}-frame chunk traced in {out['trace_s']:.1f} s "
          f"({out['trace_bytes']} B of Chrome trace)")
    return out, launches
