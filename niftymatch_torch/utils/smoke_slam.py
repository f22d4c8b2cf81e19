"""Phase 8 of ``chip_smoke.py``: SLAM tracking on the card.

    8a  feature-level parity and determinism: ``make_feature_sequence`` of
        8 cameras, 400 landmarks, 384 slots (``RansacConfig(512, 4.0)``,
        ``ba_every=3``, ``ba_window=4``) with one RANSAC draw made on the
        CPU and injected everywhere, through ``process_features`` and
        through ``process_features_batch`` in chunks of 1 + 3, 3 and 1
        frames: the card against the CPU (keyframe flags, inlier counts and
        every keyframe's track ids equal, trajectory within
        ``TRAJ_TOL_ALIGNED`` after a Sim(3) alignment) and two fresh card
        runs against each other (flags and ids equal, poses bit for bit);
    8b  the SLAM loop at the full width of ``bench.py::bench_slam_loop``:
        113 rendered 640x480 uint8 frames, ``process_frames`` in chunks of
        16 (warm-up on frames 0-32, then frames 33-112 timed with
        ``flush_ba``): frames/s, the accept fraction, relocalisations,
        inliers, the Sim(3) ATE of the keyframes against the scene, the
        kernels' launches in the timed run, and ``torch.profiler``'s
        kernels, device ms and host waits of one 16-frame chunk;
    8c  ``global_ba`` on 8b's map: the solver the rule picks, its costs and
        wall time;
    8d  a checkpoint of 8b's map restored into a fresh system on the card,
        which then processes one more frame.

Every failed check raises.  Times and profiles are CUDA-event, host-clock
and ``torch.profiler`` readings on the card and mean nothing elsewhere.
"""

from __future__ import annotations

import tempfile
import time

import numpy as np
import torch

from .smoke_sfm import _sync, profile

# The JAX package's result on 8b's clip, which the card cannot compute (it
# has no JAX): `JAX_PLATFORMS=cpu python tools/jax_slam_reference.py` on
# the JAX package of commit 27bd3d4 (one process_frames over the 113
# frames) gave accept 1.0, 0 relocalisations, inliers min 331 / median
# 452.5, 113 keyframes, Sim(3) ATE 0.19805740 over an extent of 2.2102.
JAX_ACCEPT_FRAC = 1.0
JAX_SIM3_ATE = 0.19805740
ACCEPT_MARGIN = 0.05     # 8b: accept fraction >= the JAX package's - 0.05
ATE_FACTOR = 1.5         # 8b: Sim(3) ATE <= 1.5 x the JAX package's

CLIP_FRAMES, WARMUP, CHUNK = 113, 33, 16   # 33 = 1 + 2 chunks: JAX's boundaries

# 8a, card against CPU.  Both devices' fp32 8-point refits lie ~1e-3 from
# the float64 fit, so a correspondence near the inlier threshold can fall
# on either side.  On this sequence one does at the first pair (frames
# 0-1: R 4.8e-4 apart on an H100, every later pair within 5e-6), and
# frames 0 and 1 are pinned in every window BA, so the difference stays:
# 0.017 in the raw centres, 2.4e-3 after a Sim(3) alignment.  The bound
# is on the aligned centres, with room for one such flip.
TRAJ_TOL_ALIGNED = 5e-3


def _launches():
    from niftymatch_torch.kernels import _build

    return dict(_build.LAUNCHES)


def _reset():
    from niftymatch_torch.kernels import _build

    _build.reset_launches()


def _centres(poses):
    return -np.einsum("kji,kj->ki", poses[:, :, :3], poses[:, :, 3])


# -- 8a ---------------------------------------------------------------------


def parity_phase(dev, num_cams=8):
    """8a: the port on the card against the port on the CPU, and the card
    against itself, per frame and chunked."""
    import niftymatch_torch as nt
    from niftymatch_torch.data import make_feature_sequence, make_scene
    from niftymatch_torch.geometry.ransac import _gumbel_scores
    from niftymatch_torch.utils.metrics import sim3_align

    scene = make_scene(num_cams=num_cams, num_landmarks=400, seed=0, radius=6.0,
                       width=640, height=480)
    feats = make_feature_sequence(scene, capacity=384, noise_px=0.5, seed=0)
    cfg = nt.SlamConfig(width=640, height=480,
                        intrinsics=tuple(float(v) for v in scene.intrinsics),
                        ransac=nt.RansacConfig(512, 4.0), detector_features=384,
                        ba_every=3, ba_window=4)
    draw = _gumbel_scores(512, 384, 0, torch.device("cpu"))
    splits = [(0, 4)] + [(a, min(a + 3, num_cams)) for a in range(4, num_cams, 3)]

    def run(device, chunked):
        slam = nt.SlamSystem(cfg, device=device, scores=(draw, draw))
        if chunked:
            infos = []
            for a, b in splits:
                infos += slam.process_features_batch(
                    nt.Features(*[torch.stack(x) for x in zip(*feats[a:b])]))
        else:
            infos = [slam.process_features(f) for f in feats]
        return infos, slam.poses(), [kf.track_ids.copy() for kf in slam.keyframes]

    out = {}
    for chunked in (False, True):
        path = "chunked" if chunked else "per_frame"
        t0 = time.perf_counter()
        cpu = run("cpu", chunked)
        cpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        card = run(dev, chunked)
        card_s = time.perf_counter() - t0
        again = run(dev, chunked)
        for other, what in ((cpu, "the CPU"), (again, "a second card run")):
            assert [i["keyframe"] for i in card[0]] == [i["keyframe"] for i in other[0]], what
            assert [i["num_inliers"] for i in card[0]] == [i["num_inliers"] for i in other[0]], what
            assert all((a == b).all() for a, b in zip(card[2], other[2])), \
                f"track ids differ from {what}"
        # A monocular trajectory is defined up to a similarity: compare
        # after a Sim(3) alignment, and print the raw difference too.
        aligned, scale = sim3_align(_centres(card[1]), _centres(cpu[1]))
        traj_err = float(np.abs(aligned - _centres(cpu[1])).max())
        raw_err = float(np.abs(_centres(card[1]) - _centres(cpu[1])).max())
        rerun_err = float(np.abs(card[1] - again[1]).max())
        assert all(i["keyframe"] for i in card[0]) and len(card[0]) == num_cams
        assert traj_err <= TRAJ_TOL_ALIGNED, \
            f"8a {path}: card trajectory {traj_err} from the CPU's after alignment"
        assert rerun_err == 0.0, f"8a {path}: two card runs differ by {rerun_err}"
        print(f"[slam] 8a {path}: {num_cams} frames, inliers "
              f"{[i['num_inliers'] for i in card[0]]}; card against CPU: flags, inliers and "
              f"track ids equal, Sim(3)-aligned trajectory within {traj_err:.2e} (raw "
              f"{raw_err:.2e}, scale {scale:.6f}); two card runs equal bit for bit; "
              f"{card_s:.2f} s on the card, {cpu_s:.2f} s on the CPU")
        out[path] = {"card_vs_cpu_traj_err": traj_err, "card_vs_cpu_raw_err": raw_err,
                     "card_vs_cpu_scale": scale, "card_rerun_max_diff": rerun_err,
                     "card_s": card_s, "cpu_s": cpu_s}
    return out


# -- 8b ---------------------------------------------------------------------


def clip():
    """8b's scene, uint8 frames and ``SlamConfig`` (``bench_slam_loop``)."""
    import niftymatch_torch as nt
    from niftymatch_torch.data import make_scene, render_frames

    scene = make_scene(num_cams=CLIP_FRAMES, num_landmarks=1200, seed=0, radius=6.0,
                       width=640, height=480)
    frames = np.clip(render_frames(scene, seed=0), 0, 255).astype(np.uint8)
    cfg = nt.SlamConfig(width=640, height=480,
                        intrinsics=tuple(float(v) for v in scene.intrinsics),
                        ransac=nt.RansacConfig(iterations=512, inlier_threshold=4.0),
                        detector_features=1024, min_inliers=12, chunk_size=CHUNK,
                        ba_every=4, ba_window=4, store_capacity=256)
    return scene, frames, cfg


def loop_phase(dev):
    """8b: returns (the system, the frames, the config, the true centres
    of its keyframes, the phase's numbers)."""
    import niftymatch_torch as nt
    from niftymatch_torch.utils.metrics import ate_rmse

    t0 = time.perf_counter()
    scene, frames, cfg = clip()
    render_s = time.perf_counter() - t0
    slam = nt.SlamSystem(cfg, device=dev)
    t0 = time.perf_counter()
    infos = slam.process_frames(frames[:WARMUP])
    _sync(dev)
    warm_s = time.perf_counter() - t0
    _reset()
    t0 = time.perf_counter()
    timed = slam.process_frames(frames[WARMUP:])
    slam.flush_ba()
    _sync(dev)
    timed_s = time.perf_counter() - t0
    launches = _launches()
    infos += timed
    n_timed = len(frames) - WARMUP
    assert len(infos) == len(frames)
    kept = [i for i, inf in enumerate(infos) if inf["keyframe"]]
    relocs = sum(1 for inf in infos if inf.get("reloc"))
    accept = len(kept) / len(infos)
    inliers = [inf["num_inliers"] for inf in infos[1:] if inf["keyframe"]]
    gt = _centres(scene.poses)
    extent = float(np.linalg.norm(gt - gt.mean(0), axis=1).mean())
    traj = slam.trajectory()
    assert traj.shape == (len(kept), 3) and np.isfinite(traj).all()
    ate = ate_rmse(traj, gt[kept])
    verifies = launches["k1_match_top2"] - 2 * n_timed
    print(f"[slam] 8b clip: {len(frames)} frames rendered in {render_s:.1f} s; warm-up "
          f"(frames 0-{WARMUP - 1}) {warm_s:.2f} s; frames {WARMUP}-{len(frames) - 1} + "
          f"flush_ba {timed_s:.3f} s = {n_timed / timed_s:.3f} frames/s")
    print(f"[slam] 8b accept {accept:.4f} ({len(kept)} of {len(infos)}; timed frames "
          f"{sum(i['keyframe'] for i in timed) / n_timed:.4f}), relocs {relocs}, inliers "
          f"min {min(inliers)} median {np.median(inliers):.1f}, {len(slam.keyframes)} "
          f"keyframes; Sim(3) ATE {ate:.4f} = {ate / extent:.4f} of the extent {extent:.4f} "
          f"(the JAX package on the CPU: accept {JAX_ACCEPT_FRAC}, ATE {JAX_SIM3_ATE})")
    print(f"[slam] 8b launches in the timed run: {launches} (K1 beyond 2 a frame: "
          f"{verifies}, 8 per relocalisation verify)")
    assert accept >= JAX_ACCEPT_FRAC - ACCEPT_MARGIN, f"8b accept {accept} below the bar"
    assert ate <= ATE_FACTOR * JAX_SIM3_ATE, f"8b Sim(3) ATE {ate} above the bar"
    if dev.type == "cuda":
        chunks = -(-n_timed // CHUNK)
        assert launches["k2_orientation_hist"] == launches["k3_descriptor"] == chunks, launches
        assert verifies >= 0 and verifies % 8 == 0 and launches["k1_match_top2_bf16"] == 0, \
            launches

    # One 16-frame chunk, counted and profiled, on a fresh system at the
    # clip's start (frame 0 alone first, so the chunk is frames 1-16).
    one = nt.SlamSystem(cfg, device=dev)
    one.process_frames(frames[:1])
    _sync(dev)
    _reset()
    chunk_prof = profile(lambda: one.process_frames(frames[1:1 + CHUNK]), dev)
    chunk_launches = _launches()
    print(f"[slam] 8b one {CHUNK}-frame chunk: launches {chunk_launches}; profile {chunk_prof}")
    if dev.type == "cuda":
        assert chunk_launches["k2_orientation_hist"] == chunk_launches["k3_descriptor"] == 1
        assert chunk_launches["k1_match_top2"] >= 2 * CHUNK
    numbers = {"frames": len(frames), "timed_frames": n_timed, "timed_s": timed_s,
               "frames_per_s": n_timed / timed_s, "warmup_s": warm_s, "render_s": render_s,
               "accept_frac": accept, "relocs": relocs, "inliers_min": int(min(inliers)),
               "inliers_median": float(np.median(inliers)), "keyframes": len(slam.keyframes),
               "sim3_ate": ate, "extent": extent, "ate_share_of_extent": ate / extent,
               "timed_launches": launches, "chunk_launches": chunk_launches,
               "chunk_profile": chunk_prof}
    return slam, frames, cfg, gt[kept], numbers


# -- 8c, 8d -----------------------------------------------------------------


def global_ba_phase(slam, gt_kept, dev):
    """8c: ``global_ba`` on 8b's map."""
    from niftymatch_torch.utils.metrics import ate_rmse

    before = slam.trajectory()
    t0 = time.perf_counter()
    applied = slam.global_ba()
    _sync(dev)
    wall = time.perf_counter() - t0
    info = slam.last_gba
    after = slam.trajectory()
    assert applied or info["final_cost"] > info["initial_cost"], info
    assert np.isfinite(after).all()
    ate = (ate_rmse(before, gt_kept), ate_rmse(after, gt_kept))
    print(f"[slam] 8c global_ba: {info['solver']} solver, cost {info['initial_cost']:.6g} -> "
          f"{info['final_cost']:.6g}, applied {applied}, {wall:.3f} s wall; Sim(3) ATE "
          f"{ate[0]:.4f} -> {ate[1]:.4f}")
    return {"applied": bool(applied), "wall_s": wall, "sim3_ate_before": ate[0],
            "sim3_ate_after": ate[1], **info}


def checkpoint_phase(slam, frames, cfg, dev):
    """8d: save 8b's map, restore it into a fresh system, resume."""
    import niftymatch_torch as nt
    from niftymatch_torch.utils.checkpoint import load_slam_state, save_slam_state

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        save_slam_state(tmp, slam)
        restored = nt.SlamSystem(cfg, device=dev)
        load_slam_state(tmp, restored)
        round_s = time.perf_counter() - t0
    err = float(np.abs(restored.trajectory() - slam.trajectory()).max())
    assert err <= 1e-6, f"8d restored trajectory {err} from the saved one"
    assert (restored.keyframes[-1].track_ids == slam.keyframes[-1].track_ids).all()
    status = restored.process_frame(frames[-1])
    assert {"keyframe", "num_inliers", "tracked"} <= set(status), status
    print(f"[slam] 8d checkpoint of {len(slam.keyframes)} keyframes saved and restored in "
          f"{round_s:.2f} s, trajectory within {err:.1e}; one more frame: {status}")
    return {"restored_traj_err": err, "round_trip_s": round_s, "resumed": status}


def run(dev):
    """Every part of phase 8 at the card's sizes."""
    out = {"parity": parity_phase(dev)}
    slam, frames, cfg, gt_kept, out["loop"] = loop_phase(dev)
    out["global_ba"] = global_ba_phase(slam, gt_kept, dev)
    out["checkpoint"] = checkpoint_phase(slam, frames, cfg, dev)
    return out
