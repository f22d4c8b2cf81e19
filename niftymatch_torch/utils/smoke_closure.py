"""Phase 9 of ``chip_smoke.py``: SLAM loop closure on the card.

    9a  ``tests/test_slam_e2e.py:116-152``'s 12-keyframe closed loop
        (``make_feature_sequence``, no window BA) with one RANSAC draw made
        on the CPU and injected, on the card and on the CPU: the candidate
        lists equal up to bf16 flips of the card's sweep (a count within
        2 % + 2 of ``loop_min_matches``), the applied edges equal, the
        trajectories after ``close_loops`` within ``TRAJ_TOL_ALIGNED``
        after a Sim(3) alignment (also on the CPU's map carried to the
        card: with no window BA the two devices' tracking can already
        differ there, and the closure must not widen that gap); on the
        card the test's bars: an edge applied, the ATE falls, to under 1 %
        of the extent, and ``finalize(rounds=2)`` ends within 1.5x the ATE
        after closure.
    9b  the JAX package's golden closed loop at full width
        (``benchmarks/ate_artifact.py``'s standard variant, rendered with
        the port's ``data/synthetic``): 96 frames of 640x480 through
        ``process_frames``, then ``close_loops``, ``global_ba`` and
        ``finalize(rounds=2)``.  Bars: an edge applied, the Sim(3) ATE
        falls with the closure, the final ATE within 1.5x the ATE after
        closure and within 1.5x the JAX package's 0.3936; the card's bf16
        sweep against the oracle on the same store: every count within 2
        of the oracle's at bf16 operand precision (the same function), so
        that its differences from the fp32 oracle, which are printed, are
        the operands' bf16 rounding, and any candidate on which it and the
        fp32 oracle disagree is one the bf16 oracle also decides so; and
        against the fp32 oracle, every count within ``fp32_band`` and at
        most ``FP32_OUTSIDE_SHARE`` of them outside ``flip_band``.
        Prints the closure's stage seconds, K1
        bf16 launches per sweep (the live keyframes), ``torch.profiler``'s
        kernels, device ms and host waits of one ``close_loops``,
        ``finalize``'s rounds and the ATEs.

    python3 -m niftymatch_torch.utils.smoke_closure --variant hard

runs ``ate_artifact.py``'s 200-frame ``hard`` variant (seed 1, exposure
drift 0.25, two blur gaps and two noise gaps) the same way and prints its
numbers; it is not part of ``chip_smoke.py``.

Every failed check raises.  Times and profiles are host-clock and
``torch.profiler`` readings on the card and mean nothing elsewhere.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .smoke_sfm import _sync, profile
from .smoke_slam import _centres, _launches, _reset

# The JAX package's standard golden loop (ATE_r05.json, a TPU run): Sim(3)
# ATE 1.731 before closure, 0.376 after, 0.394 final, 1 loop edge, over an
# extent of 17.02.  An accuracy result, not a speed.
JAX_FINAL_ATE = 0.39358
ATE_FACTOR = 1.5
# ate_artifact.py's hard variant (ATE_r05.json): 1.798 / 0.274 / 0.179.
JAX_HARD_ATES = (1.798467, 0.273983, 0.179194)
# 9a, card against CPU: phase 8a's bound on Sim(3)-aligned centres.
TRAJ_TOL_ALIGNED = 5e-3


def flip_band(count):
    """How far a bf16 sweep count may lie from the fp32 oracle's where the
    count is far above the threshold (9a)."""
    return 0.02 * count + 2


# A count of the bf16 sweep against the oracle at bf16 operand precision:
# the same function, its products summed in another order, so a ratio test
# within ~1e-6 of the threshold can still flip.
SLACK = 2
# 9b, the bf16 sweep against the fp32 oracle: the operands' rounding moved
# counts by up to 5 on the standard clip and 6 on the hard one, with 2.8 %
# and 3.2 % of the entries outside ``flip_band`` (H100 runs in PERF.md).
# The limits: each |delta| within 2 % + 6 + SLACK, and at most 5 % of the
# entries outside ``flip_band``.
FP32_SPREAD = 6 + SLACK
FP32_OUTSIDE_SHARE = 0.05


def fp32_band(count):
    """How far a bf16 sweep count may lie from the fp32 oracle's (9b)."""
    return 0.02 * count + FP32_SPREAD


# -- 9a ---------------------------------------------------------------------


def _loop12(device, draw, carry_from=None):
    """The 12-keyframe loop on ``device``; with ``carry_from`` (another
    run's result) that run's poses, track ids and landmarks replace the
    tracked map before the closure."""
    import niftymatch_torch as nt
    from niftymatch_torch.data import make_feature_sequence, make_scene

    K = 12
    scene = make_scene(num_cams=K, num_landmarks=800, seed=1, radius=6.0, width=640,
                       height=480, arc=(0.0, 2 * np.pi * (K - 1) / K))
    feats = make_feature_sequence(scene, capacity=384, noise_px=1.0, seed=1)
    cfg = nt.SlamConfig(width=640, height=480,
                        intrinsics=tuple(float(v) for v in scene.intrinsics),
                        ransac=nt.RansacConfig(512, 4.0), detector_features=384,
                        ba_every=10_000, loop_min_gap=4, loop_min_matches=40)
    slam = nt.SlamSystem(cfg, device=device, scores=(draw, draw))
    for f in feats:
        slam.process_features(f)
    if carry_from is not None:
        src = carry_from["map"]
        for kf, pose, ids in zip(slam.keyframes, src["poses"], src["track_ids"]):
            kf.pose = torch.from_numpy(pose).to(device)
            kf.track_ids = ids.copy()
        slam.track_positions = src["positions"].copy()
        slam.track_alive = src["alive"].copy()
    r = {"before": slam.trajectory(), "candidates": slam.detect_loop_candidates()}
    r["map"] = {"poses": slam.poses(), "track_ids": [kf.track_ids.copy() for kf in slam.keyframes],
                "positions": slam.track_positions.copy(), "alive": slam.track_alive.copy()}
    t0 = time.perf_counter()
    r["edges"] = slam.close_loops()
    _sync(slam.device)
    r["close_s"] = time.perf_counter() - t0
    r["stages"] = dict(slam.last_closure_stages)
    r["closed"] = slam.trajectory()
    r["finalize"] = slam.finalize(rounds=2)
    r["final"] = slam.trajectory()
    r["gt"] = _centres(scene.poses)
    r["loop_min_matches"] = cfg.loop_min_matches
    return r


def _aligned(a, b):
    from niftymatch_torch.utils.metrics import sim3_align

    al, _ = sim3_align(a, b)
    return float(np.abs(al - b).max())


def _same_candidates(card, cpu, band_of):
    """Candidates of the two runs equal, except pairs whose count lies within
    the flip band of ``loop_min_matches``; returns the differing pairs."""
    a = {c[:2]: c[2] for c in card}
    b = {c[:2]: c[2] for c in cpu}
    differ = sorted(set(a) ^ set(b))
    for p in differ:
        n = a.get(p, b.get(p))
        assert band_of(n), f"candidate {p} ({n} matches) differs outside the bf16 band"
    return differ


def parity_phase(dev):
    """9a: card against CPU on the 12-keyframe loop."""
    from niftymatch_torch.geometry.ransac import _gumbel_scores
    from niftymatch_torch.utils.metrics import ate_rmse

    draw = _gumbel_scores(512, 384, 0, torch.device("cpu"))
    cpu = _loop12("cpu", draw)
    card = _loop12(dev, draw)
    carried = _loop12(dev, draw, carry_from=cpu)
    lm = cpu["loop_min_matches"]
    out = {}
    for name, run in (("card", card), ("carried", carried)):
        differ = _same_candidates(run["candidates"], cpu["candidates"],
                                  lambda n: abs(n - lm) <= flip_band(n))
        assert run["edges"] == cpu["edges"], f"9a {name}: {run['edges']} edges, CPU {cpu['edges']}"
        gap_before = _aligned(run["before"], cpu["before"])
        gap = _aligned(run["closed"], cpu["closed"])
        out[name] = {"candidates_differ": differ, "edges": run["edges"],
                     "aligned_err_before": gap_before, "aligned_err_closed": gap,
                     "aligned_err_final": _aligned(run["final"], cpu["final"]),
                     "close_s": run["close_s"], "stages": run["stages"]}
    # The CPU's own map on the card: the closure agrees within the bar.  On
    # the card's own map the tracking may already differ; the closure must
    # then not widen the gap.
    assert out["carried"]["aligned_err_closed"] <= TRAJ_TOL_ALIGNED, out["carried"]
    c = out["card"]
    assert c["aligned_err_closed"] <= max(TRAJ_TOL_ALIGNED, c["aligned_err_before"]), c
    gt = card["gt"]
    extent = float(np.linalg.norm(gt - gt.mean(0), axis=1).mean())
    ates = [ate_rmse(card[w], gt) for w in ("before", "closed", "final")]
    print(f"[closure] 9a 12-keyframe loop, card against CPU: {card['edges']} edges "
          f"applied on both; candidates {len(card['candidates'])} / "
          f"{len(cpu['candidates'])} (differing {c['candidates_differ']}); Sim(3)-aligned "
          f"trajectory gap {c['aligned_err_before']:.2e} before closure, "
          f"{c['aligned_err_closed']:.2e} after, {c['aligned_err_final']:.2e} after "
          f"finalize; on the CPU's map carried to the card "
          f"{out['carried']['aligned_err_closed']:.2e} after closure")
    print(f"[closure] 9a card: ATE {ates[0]:.5f} -> {ates[1]:.5f} (closure) -> "
          f"{ates[2]:.5f} (finalize {card['finalize']['rounds']}), extent {extent:.4f}; "
          f"close_loops {card['close_s']:.3f} s, stages {card['stages']}")
    assert card["edges"] > 0 and ates[1] < ates[0] and ates[1] < 0.01 * extent, ates
    assert card["finalize"]["rounds"] and ates[2] <= ATE_FACTOR * ates[1], ates
    out["ate"] = {"before": ates[0], "closed": ates[1], "final": ates[2], "extent": extent}
    return out


# -- 9b and the hard variant -----------------------------------------------


def golden_clip(variant: str = "standard"):
    """``ate_artifact.py``'s golden closed loop: (scene, uint8 frames,
    SlamConfig).  ``hard``: 200 frames, seed 1, exposure drift, blur and
    noise gaps (``ate_artifact.py:53-104, 416-423``)."""
    import niftymatch_torch as nt
    from niftymatch_torch.data import make_scene, render_frames

    n, seed = (96, 0) if variant == "standard" else (200, 1)
    scene = make_scene(num_cams=n, num_landmarks=1200, seed=seed, radius=6.0, width=640,
                       height=480, arc=(0.0, 2.0 * np.pi * (n - 1) / n), helix=0.0)
    frames = render_frames(scene, seed=seed, background="flat")
    if variant == "hard":
        # Exposure drift: gain in [0.75, 1.25], bias up to +-3 gray levels.
        ph = np.linspace(0, 2 * np.pi, n)
        frames = (frames * (1.0 + 0.25 * np.sin(ph))[:, None, None]
                  + (12.0 * 0.25 * np.sin(2.3 * ph + 0.7))[:, None, None])
        k = np.exp(-0.5 * (np.arange(-6, 7) / 2.5) ** 2)
        k /= k.sum()
        for lo, hi in ((n // 3, n // 3 + 3), (2 * n // 3, 2 * n // 3 + 3)):
            for i in range(lo, min(hi, n)):   # defocus
                f = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 1, frames[i])
                frames[i] = np.apply_along_axis(lambda c: np.convolve(c, k, mode="same"), 0, f)
        for lo, hi in ((2 * n // 5, 2 * n // 5 + 3), (4 * n // 5, 4 * n // 5 + 3)):
            rng = np.random.default_rng(1234 + lo)
            for i in range(lo, min(hi, n)):   # signal dropout
                frames[i] = rng.uniform(0, 255, frames[i].shape)
    frames = np.clip(frames, 0, 255).astype(np.uint8)   # as the PNG round trip leaves it
    cfg = nt.SlamConfig(width=640, height=480, intrinsics=(525.0, 525.0, 320.0, 240.0),
                        ransac=nt.RansacConfig(iterations=1024, inlier_threshold=4.0),
                        detector_features=1024, min_inliers=12, chunk_size=16, ba_every=4,
                        ba_window=4, loop_min_matches=40, loop_min_gap=max(3, n // 4),
                        reloc_window=6, store_capacity=1 << int(np.ceil(np.log2(max(64, n)))))
    return scene, frames, cfg


def sweep_against_oracle(slam) -> dict:
    """The system's sweep (K1 bf16 on the card) against the oracle
    (``allpairs_match``, plain torch) on the same device and store, in fp32
    and at bf16 operand precision (norms fp32, as K1 computes them).

    ``kernel_excess``: the largest |sweep - bf16 oracle| beyond ``SLACK``
    (the same function, summed in another order), <= 0 when the sweep is
    right; so every difference from the fp32 oracle is the bf16 rounding
    of the operands.  Also the entries that differ from the fp32 oracle,
    the largest, how many lie outside ``flip_band`` and ``fp32_band`` of
    the fp32 count, and the
    candidate pairs on which the sweep and the fp32 oracle disagree, each
    with the bf16 oracle's count."""
    from niftymatch_torch.parallel import allpairs_match

    K = len(slam.keyframes)
    buf = slam._store.view()
    sweep = slam.closer.sweep().counts.cpu().numpy().astype(np.int64)
    o32, o16 = (allpairs_match(buf.desc[:K], buf.valid[:K], ambiguity=0.7, mutual=True,
                               precision=p).counts.cpu().numpy().astype(np.int64)
                for p in ("fp32", "bf16"))
    delta = sweep - o32
    diff = np.argwhere(delta != 0)
    worst = sorted(((int(abs(delta[i, j])), int(i), int(j), int(o32[i, j]), int(sweep[i, j]),
                     int(o16[i, j])) for i, j in diff), reverse=True)[:6]
    lm, gap = slam.config.loop_min_matches, slam.config.loop_min_gap
    cands = [(int(i), int(j), int(o32[i, j]), int(sweep[i, j]), int(o16[i, j]))
             for i, j in diff
             if j - i >= gap and (o32[i, j] >= lm) != (sweep[i, j] >= lm)]
    return {"entries": K * K, "differing": int(len(diff)),
            "max_abs_delta": int(np.abs(delta).max()),
            "max_rel_delta": float((np.abs(delta) / np.maximum(o32, 1)).max()),
            "outside_2pct_plus_2": int((np.abs(delta) > flip_band(o32)).sum()),
            "outside_fp32_band": int((np.abs(delta) > fp32_band(o32)).sum()),
            "bf16_oracle_differing": int((o16 != o32).sum()),
            "largest (|d|, i, j, fp32, sweep, bf16 oracle)": worst,
            "candidates_differing (i, j, fp32, sweep, bf16 oracle)": cands,
            "kernel_excess": int((np.abs(sweep - o16) - SLACK).max())}


def golden_phase(dev, variant: str = "standard"):
    """9b (or the hard variant): the golden loop through tracking, closure,
    global BA and ``finalize``, with the launches of the whole run."""
    import niftymatch_torch as nt
    from niftymatch_torch.utils.metrics import ate_rmse

    t0 = time.perf_counter()
    scene, frames, cfg = golden_clip(variant)
    render_s = time.perf_counter() - t0
    slam = nt.SlamSystem(cfg, device=dev)
    _reset()
    warm = min(2 * cfg.chunk_size + 1, len(frames) - cfg.chunk_size)
    t0 = time.perf_counter()
    infos = slam.process_frames(frames[:warm])
    slam.prewarm_reloc()
    _sync(dev)
    t1 = time.perf_counter()
    infos += slam.process_frames(frames[warm:])
    slam.flush_ba()
    _sync(dev)
    track_s, timed_s = time.perf_counter() - t0, time.perf_counter() - t1
    tracked = _launches()
    kept = [i for i, inf in enumerate(infos) if inf["keyframe"]]
    gt = _centres(scene.poses)[kept]
    extent = float(np.linalg.norm(gt - gt.mean(0), axis=1).mean())
    K = len(slam.keyframes)
    ate_pre = ate_rmse(slam.trajectory(), gt)

    # The sweep on the card against the fp32 oracle on the same store (a
    # comparison: its launches are not the path's).
    sweep_cmp = sweep_against_oracle(slam)
    print(f"[closure] 9b bf16 sweep against the oracle: {sweep_cmp}")
    assert sweep_cmp["kernel_excess"] <= 0, "the sweep differs from the bf16 oracle"
    assert sweep_cmp["outside_fp32_band"] == 0, "the sweep drifts from the fp32 oracle"
    assert sweep_cmp["outside_2pct_plus_2"] <= FP32_OUTSIDE_SHARE * sweep_cmp["entries"], \
        "too many sweep counts outside 2 % + 2 of the fp32 oracle's"
    for i, j, n32, n, n16 in sweep_cmp["candidates_differing (i, j, fp32, sweep, bf16 oracle)"]:
        lm = cfg.loop_min_matches
        assert (n16 >= lm) == (n >= lm) or abs(n - lm) <= SLACK, \
            f"candidate ({i}, {j}) differs from the fp32 oracle's beyond bf16 rounding"

    _reset()
    t0 = time.perf_counter()
    edges = slam.close_loops()
    _sync(dev)
    close_s = time.perf_counter() - t0
    sweep_launches = _launches()
    stages = dict(slam.last_closure_stages)
    ate_closed = ate_rmse(slam.trajectory(), gt)
    _reset()
    t0 = time.perf_counter()
    gba = slam.global_ba()
    _sync(dev)
    gba_s = time.perf_counter() - t0
    ate_gba = ate_rmse(slam.trajectory(), gt)
    t0 = time.perf_counter()
    fin = slam.finalize(rounds=2)
    _sync(dev)
    fin_s = time.perf_counter() - t0
    ate_final = ate_rmse(slam.trajectory(), gt)
    launches = {k: tracked[k] + sweep_launches[k] + v for k, v in _launches().items()}
    # One more closure on the final map, under the profiler.
    prof = profile(slam.close_loops, dev)
    out = {"variant": variant, "frames": len(frames), "keyframes": K,
           "relocs": sum(1 for i in infos if i.get("reloc")), "render_s": render_s,
           "track_s": track_s, "timed_frames_per_s": (len(frames) - warm) / timed_s,
           "loop_edges": int(edges), "close_loops_s": close_s, "stages": stages,
           "k1_bf16_per_sweep": sweep_launches["k1_match_top2_bf16"],
           "close_loops_launches": sweep_launches, "global_ba": bool(gba), "gba_s": gba_s,
           "gba_guard": getattr(slam, "last_gba_guard", None),
           "finalize_rounds": fin["rounds"], "finalize_s": fin_s,
           "ate_pre_closure": ate_pre, "ate_post_closure": ate_closed,
           "ate_post_gba": ate_gba, "ate_final": ate_final, "extent": extent,
           "sweep_against_oracle": sweep_cmp, "close_loops_profile": prof,
           "launches": launches}
    buf = slam._store.view()
    store = (buf.desc[:K].contiguous(), buf.valid[:K].contiguous())
    print(f"[closure] 9b {variant} golden loop: {len(frames)} frames rendered in "
          f"{render_s:.1f} s, tracked in {track_s:.1f} s ({out['timed_frames_per_s']:.3f} "
          f"frames/s after {warm}), {K} keyframes, {out['relocs']} relocs")
    print(f"[closure] 9b close_loops: {edges} edges in {close_s:.3f} s; stages {stages}; "
          f"K1 bf16 launches per sweep {out['k1_bf16_per_sweep']} ({K} live keyframes); "
          f"launches {sweep_launches}")
    print(f"[closure] 9b one close_loops under torch.profiler: {prof}")
    print(f"[closure] 9b global_ba applied {gba} ({gba_s:.3f} s, guard "
          f"{out['gba_guard']}); finalize {fin['rounds']} in {fin_s:.3f} s")
    print(f"[closure] 9b Sim(3) ATE {ate_pre:.4f} -> {ate_closed:.4f} (closure) -> "
          f"{ate_gba:.4f} (global BA) -> {ate_final:.4f} (finalize), extent {extent:.3f}")
    assert edges >= 1, "9b: no loop edge applied"
    assert ate_closed < ate_pre, f"9b: closure did not lower the ATE ({ate_pre} -> {ate_closed})"
    assert ate_final <= ATE_FACTOR * ate_closed, f"9b: finalize ATE {ate_final}"
    if variant == "standard":
        assert ate_final <= ATE_FACTOR * JAX_FINAL_ATE, f"9b: final ATE {ate_final}"
        if dev.type == "cuda":
            assert out["k1_bf16_per_sweep"] == K, sweep_launches
    return out, store, cfg


def run(dev):
    """Every part of phase 9 at the card's sizes.  Returns (the numbers,
    9b's keyframe store (desc, valid) of its live keyframes, 9b's
    SlamConfig) for phase 10a."""
    parity = parity_phase(dev)
    golden, store, cfg = golden_phase(dev)
    return {"parity": parity, "golden": golden}, store, cfg


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--variant", choices=("standard", "hard"), default="hard")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from niftymatch_torch.kernels import _build

    _build.build_all()
    out = golden_phase(torch.device("cuda"), args.variant)[0]
    if args.variant == "hard":
        print(f"[closure] the JAX package's hard variant (ATE_r05.json): "
              f"{JAX_HARD_ATES[0]} / {JAX_HARD_ATES[1]} / {JAX_HARD_ATES[2]}")
    print(json.dumps({"closure": out}, default=str))


if __name__ == "__main__":
    main()
