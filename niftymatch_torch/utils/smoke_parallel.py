"""Phase 10a-10c of ``chip_smoke.py``: the multi-device layer on one card.

NCCL refuses two ranks on one device, so the layer runs in two modes:
world 1 on NCCL (a process group of this process alone) and world 2 on
gloo, two spawned processes that both use ``cuda:0`` and stage every
transfer through host memory (``parallel/comm.py``).  World 2's times
therefore cross the host and say nothing of NVLink or a multi-GPU ring.

    10a  the ring at full width: 16 640x480 frames through
         ``shard_detect`` (the gathered features equal to the world-1
         batch within 1e-5), then ``ring_allpairs_match`` over their
         16 x 2,048 x 128 descriptors, each rank passing its own frames,
         with and without ``mutual``, with
         indices (world 2 equal to world 1 exactly; against
         ``allpairs_match``, the fp32 oracle on the card, every row that
         differs one whose ratio test fp32 noise decides, see MARGIN_EPS;
         the counts that differ printed), the padded K = 15 at both worlds
         (equal), and phase 9b's keyframe store (96 x 1,024, mutual,
         ambiguity 0.7) at both worlds with the same checks and no
         candidate decision differing from the oracle's; ms per
         sweep in the "full", "compute" and "comm" modes, and K1's
         launches per sweep;
    10b  distributed BA: the PCG solver on phase 7c's problem (512 x
         131,072 x 2,097,152) and on phase 7b's 16 x 4,096 window, and the
         dense solver on that window; at world 1 the cost trace and poses
         equal to ``bundle_adjust_cg`` / ``bundle_adjust`` on the same
         (partition-ordered) problem bit for bit, and a rerun bit for bit;
         at world 2 the final cost within 1e-4 relative of world 1's, the
         window's poses within 1e-3 of world 1's and 7c's within 0.25 of
         the truth (see TRUTH_ATOL), printed beside a relabelled world-1
         solve's gap; wall s, M obs-updates/s, peak memory per rank and
         all-reduces per LM iteration;
    10c  phase 9a's 12-keyframe loop with one injected draw at world 2
         (the closure's sweep through the ring) against the world-1 card
         run (its sweep K1 bf16): candidates equal up to bf16 flips,
         applied edges equal, the trajectories within 9a's bar after a
         Sim(3) alignment.

Every failed check raises; a failed child makes the spawn raise.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

# 10a against the fp32 oracle.  K1 fp32 (3xTF32) and the oracle's GEMM sum
# in other orders, and ||a||^2 + ||b||^2 - 2 a.b of unit descriptors loses
# up to ~4e-6 to cancellation (phase 2: K1 within 3.7e-6 of its plain
# version), so a row's ratio test (min1 < a * min2) is decided by fp32 noise
# where its float64 margin |a * min2 - min1| is below MARGIN_EPS.  Such rows
# are many on these frames: near-duplicate descriptors (a blob found at two
# neighbouring scales, and the 5-px shifted copies) put both nearest
# distances at the cancellation floor, where the fp32 oracle on the card and
# on the CPU also part from float64 (``tools/ring_oracle_gap.py``).  The bar:
# every row on which the ring and the oracle differ is such a row (for a
# mutual match, its forward row or one of the backward rows involved).
MARGIN_EPS = 1e-5
# 10b, world 2 against world 1 (the shards' sums are added in another order).
# A noise-free window's cost ends at the fp32 floor (phase 7b: below 1e-6
# of its start), where a relative difference means nothing: a final cost is
# compared relative to the larger of the two and FLOOR times the start.
COST_RTOL, POSE_ATOL, FLOOR = 1e-4, 1e-3, 1e-6
# 7c's PCG solve leaves its poses along directions its cost hardly sees: the
# same solve at world 1 with the landmarks relabelled (every sum in another
# order, ``relabelled``) lands about as far from it as world 2 does, also
# after 24 x 200 iterations with equal final costs (``tools/ba_world_gap.py``;
# H100 readings in PERF.md).  So world 2's 7c poses are held, as phase 7c
# holds them, to TRUTH_ATOL of the scene's, and printed beside the
# relabelled run's gap; PCG's sharding is held to POSE_ATOL on 7b's window,
# whose cost fixes its poses.
TRUTH_ATOL = 0.25
TIMING_REPS = 5
RING_NOTE = ("world 2's transfers cross the host (gloo, both ranks on cuda:0): its times "
             "say nothing of NVLink or a multi-GPU ring")


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _launches():
    from ..kernels import _build

    return dict(_build.LAUNCHES)


def _reset():
    from ..kernels import _build

    _build.reset_launches()


def _barrier():
    if dist.get_world_size() > 1:
        dist.barrier()


# -- work done on every rank, at world 1 in this process and at world 2 ------


def _detect(frames, cfg, mesh):
    """This rank's rows of the batch through ``shard_detect``, and every
    rank's rows gathered."""
    from ..parallel import gather_features, shard_detect
    from ..sift import detect_and_describe_batch

    mine = shard_detect(lambda x: detect_and_describe_batch(x, cfg, device=frames.device),
                        frames, mesh)
    return mine, gather_features(mine, mesh)


def _ring(desc, valid, mesh, **kw):
    """The ring over a batch every rank holds: each passes its rows."""
    from ..parallel import ring_allpairs_match, ring_rows

    rows = ring_rows(desc.shape[0], mesh)
    return ring_allpairs_match(desc[rows], valid[rows], mesh, num_frames=desc.shape[0], **kw)


def _ring_work(frames, cfg, store, k_pad):
    """10a on this rank: detection, the ring runs with their launches,
    the sweep times; CPU results."""
    from ..parallel import make_keyframe_mesh, ring_allpairs_match

    mesh = make_keyframe_mesh(device_type=frames.device.type)
    out = {"world": dist.get_world_size()}
    _sync()
    _reset()
    mine, feats = _detect(frames, cfg, mesh)
    r = ring_allpairs_match(mine.desc, mine.valid, mesh, ambiguity=0.8, mutual=True,
                            return_indices=True)
    _sync()
    out["path_launches"] = _launches()            # shard_detect + one mutual sweep
    out["features"] = [t.cpu() for t in feats]
    out["runs"] = {}
    for name, kw, desc, valid in (
            ("plain", dict(ambiguity=0.8, mutual=False, return_indices=True),
             feats.desc, feats.valid),
            ("mutual", dict(ambiguity=0.8, mutual=True, return_indices=True),
             feats.desc, feats.valid),
            (f"k{k_pad}", dict(ambiguity=0.8, mutual=True, return_indices=True),
             feats.desc[:k_pad], feats.valid[:k_pad]),
            ("store", dict(ambiguity=0.7, mutual=True, return_indices=True), *store)):
        _reset()
        res = _ring(desc, valid, mesh, **kw)
        _sync()
        out["runs"][name] = {"counts": res.counts.cpu(),
                             "indices": None if res.indices is None else res.indices.cpu(),
                             "launches": _launches()}
    assert torch.equal(out["runs"]["mutual"]["counts"], r.counts.cpu())
    out["sweep_ms"] = {}
    for what, (desc, valid) in (("16x2048", (feats.desc, feats.valid)), ("store", store)):
        for phase in ("full", "compute", "comm"):
            def sweep():
                return _ring(desc, valid, mesh, ambiguity=0.7, mutual=True, phase=phase)
            sweep()
            _sync()
            _barrier()
            t0 = time.perf_counter()
            for _ in range(TIMING_REPS):
                sweep()
            _sync()
            _barrier()
            out["sweep_ms"][f"{what}_{phase}"] = 1e3 * (time.perf_counter() - t0) / TIMING_REPS
    return out, mesh, feats


def _ba_work(problems, mesh):
    """10b on this rank: each solver twice (the second a rerun), timed,
    with its all-reduces and peak memory (on a card); CPU results."""
    from ..parallel import comm, distributed_bundle_adjust, distributed_bundle_adjust_cg

    cuda = mesh.device_type == "cuda"
    out = {}
    for name, (sharded, cfg, n_obs) in problems.items():
        solve = distributed_bundle_adjust_cg if _is_cg(name) else distributed_bundle_adjust
        runs = []
        for _ in range(2):
            _sync()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            comm.reset_counts()
            _barrier()
            t0 = time.perf_counter()
            solved, stats = solve(sharded, mesh, cfg)
            _sync()
            wall = time.perf_counter() - t0
            runs.append({"poses": solved.poses.cpu(), "costs": stats.costs.cpu(),
                         "initial_cost": float(stats.initial_cost),
                         "final_cost": float(stats.final_cost), "wall_s": wall,
                         "obs_updates_per_s_M": n_obs * cfg.max_iterations / wall / 1e6,
                         "peak_memory_bytes": torch.cuda.max_memory_allocated() if cuda
                         else None,
                         "all_reduce_per_lm_iteration":
                             (comm.COUNTS["all_reduce"] - 1) / cfg.max_iterations})
            del solved, stats
        out[name] = runs
    return out


def world2_task(device, frames, cfg, store, k_pad, problems, draw):
    """Everything world 2 runs on one rank (gloo; on a card, cuda:0)."""
    from .smoke_closure import _loop12

    dev = torch.device(device)
    ring, mesh, _ = _ring_work(frames.to(dev), cfg, tuple(t.to(dev) for t in store), k_pad)
    ba = _ba_work(problems, mesh)
    _reset()
    loop = _loop12(dev, draw)
    loop["launches"] = _launches()
    return {"ring": ring, "ba": ba, "loop": loop}


# -- checks in this process --------------------------------------------------


def _same_features(got, want, what):
    """Two gathered batches equal within 1e-5, compared per frame sorted
    by (x, y)."""
    worst = 0.0
    for i in range(want[0].shape[0]):
        vg, vw = got[-1][i].numpy(), want[-1][i].numpy()
        assert vg.sum() == vw.sum(), f"{what}: frame {i} counts differ"
        og = np.lexsort((got[1][i].numpy()[vg], got[0][i].numpy()[vg]))
        ow = np.lexsort((want[1][i].numpy()[vw], want[0][i].numpy()[vw]))
        for g, w in zip(got[:-1], want[:-1]):
            worst = max(worst, float(np.abs(g[i].numpy()[vg][og].astype(np.float64)
                                            - w[i].numpy()[vw][ow]).max()))
    assert worst <= 1e-5, f"{what}: features differ by {worst}"
    return worst


def margins64(desc, valid, ambiguity):
    """Each row's ratio-test margin ``ambiguity * min2 - min1`` against
    every frame, (K, K, N) float64 on ``desc``'s device, computed in
    float64 (inf for an invalid row or a frame with fewer than two valid
    slots)."""
    K, N, _ = desc.shape
    d = desc.to(torch.float64)
    norm = (d * d).sum(-1)
    out = torch.empty((K, K, N), dtype=torch.float64, device=desc.device)
    for i in range(K):
        dist = torch.clamp(norm[i][None, :, None] + norm[:, None, :]
                           - 2.0 * torch.matmul(d[i], d.transpose(1, 2)), min=0.0)
        dist = torch.where(valid[:, None, :], dist, torch.full_like(dist, float("inf")))
        two = torch.topk(dist, 2, dim=-1, largest=False).values
        m = ambiguity * two[..., 1] - two[..., 0]
        out[i] = torch.where(valid[i][None, :] & torch.isfinite(m), m,
                             torch.full_like(m, float("inf")))
    return out


def _against_oracle(idx, oracle_idx, margins, mutual, what):
    """Rows where the ring and the oracle differ, and whether each is one
    whose ratio test fp32 noise decides (see MARGIN_EPS)."""
    ill = margins.abs() < MARGIN_EPS                         # (K, K, N), row (i, j, n)
    diff = idx != oracle_idx
    explained = ill
    if mutual:
        # The backward rows (j, i, m) of either side's match m.
        back = ill.transpose(0, 1)
        for m in (idx, oracle_idx):
            explained = explained | (torch.gather(back, -1, m.clamp(min=0).long()) & (m >= 0))
    delta = ((idx >= 0).sum(-1) - (oracle_idx >= 0).sum(-1)).abs()
    out = {"rows_differing": int(diff.sum()), "rows_differing_unexplained":
           int((diff & ~explained).sum()), "ill_conditioned_rows": int(ill.sum()),
           "counts_differing": int((delta > 0).sum()), "count_entries": delta.numel(),
           "max_abs_count_delta": int(delta.max())}
    print(f"[parallel] 10a {what} against the fp32 oracle: {out['counts_differing']} of "
          f"{out['count_entries']} counts differ, by at most {out['max_abs_count_delta']}; "
          f"{out['rows_differing']} rows differ, {out['rows_differing_unexplained']} of them "
          f"with a float64 margin of at least {MARGIN_EPS:g} ({out['ill_conditioned_rows']} "
          f"rows below it)")
    assert out["rows_differing_unexplained"] == 0, f"10a {what}: the ring disagrees with the oracle"
    return out


def _candidates(counts, lm, gap):
    c = counts.numpy()
    return {(int(i), int(j)) for i, j in zip(*np.nonzero(np.triu(c >= lm, k=gap)))}


def _ring_checks(w1, w2, oracle, margins, loop_min_matches, loop_min_gap, cuda):
    out = {"oracle": {}}
    K = w1["runs"]["mutual"]["counts"].shape[0]
    for name, run in w1["runs"].items():
        other = w2["runs"][name]
        assert torch.equal(run["counts"], other["counts"]), f"10a {name}: world 2 != world 1"
        if run["indices"] is not None:
            assert torch.equal(run["indices"], other["indices"]), \
                f"10a {name}: world 2's indices != world 1's"
    for name in ("plain", "mutual", "store"):
        out["oracle"][name] = _against_oracle(w1["runs"][name]["indices"], oracle[name].indices,
                                              margins[name], name != "plain", name)
    ring_c = _candidates(w1["runs"]["store"]["counts"], loop_min_matches, loop_min_gap)
    orac_c = _candidates(oracle["store"].counts, loop_min_matches, loop_min_gap)
    out["store_candidates"] = len(ring_c)
    out["store_candidates_differing"] = sorted(ring_c ^ orac_c)
    assert ring_c == orac_c, f"10a store: candidate decisions differ {ring_c ^ orac_c}"
    for w in (w1, w2) if cuda else ():
        n, kl = w["world"], -(-K // w["world"])
        for name, mult in (("plain", 1), ("mutual", 2)):
            want = mult * n * kl
            got = w["runs"][name]["launches"]
            assert got["k1_match_top2"] == want and got["k1_match_top2_bf16"] == 0, \
                f"10a {name} at world {n}: K1 launches {got}, expected {want}"
    out["launches_per_sweep"] = {f"world{w['world']}_{name}": w["runs"][name]["launches"]
                                 for w in (w1, w2) for name in w["runs"]}
    return out


def _ba_checks(w1, w2, refs, truths, witness):
    out = {}
    for name, runs in w1.items():
        ref = refs[name]
        first, again = runs
        assert torch.equal(first["costs"], ref["costs"]) \
            and first["initial_cost"] == ref["initial_cost"] \
            and torch.equal(first["poses"], ref["poses"]), \
            f"10b {name}: world 1 differs from the single-device solver"
        assert torch.equal(first["costs"], again["costs"]) \
            and torch.equal(first["poses"], again["poses"]), f"10b {name}: rerun differs"
        assert torch.equal(w2[name][0]["costs"], w2[name][1]["costs"]) \
            and torch.equal(w2[name][0]["poses"], w2[name][1]["poses"]), \
            f"10b {name}: world 2's rerun differs"
        two = w2[name][1]
        rel = abs(two["final_cost"] - first["final_cost"]) / max(
            two["final_cost"], first["final_cost"], FLOOR * first["initial_cost"])
        pose = float((two["poses"] - first["poses"]).abs().max())
        truth = [float((r["poses"] - truths[name]).abs().max()) for r in (first, two)]
        bar = TRUTH_ATOL if name == "cg" else POSE_ATOL
        ok = max(truth) <= TRUTH_ATOL if name == "cg" else pose <= POSE_ATOL
        assert rel <= COST_RTOL and ok, \
            f"10b {name}: world 2 cost {rel:.2e} relative, poses {pose:.2e} from world 1, " \
            f"{truth} from the truth"
        strip = ("poses", "costs")
        out[name] = {"world1": [{k: v for k, v in r.items() if k not in strip} for r in runs],
                     "world2": [{k: v for k, v in r.items() if k not in strip}
                                for r in w2[name]],
                     "world2_final_cost_rel": rel, "world2_pose_max_diff": pose,
                     "pose_max_err_vs_truth_world1_world2": truth,
                     "costs": first["costs"].tolist()}
        held = (f"poses {truth[0]:.4f} / {truth[1]:.4f} from the truth (bar {bar:g})"
                if name == "cg" else f"poses {pose:.2e} from world 1's (bar {bar:g})")
        print(f"[parallel] 10b {name}: world 1 = the single-device solver and a rerun bit for "
              f"bit (cost {first['initial_cost']:.9g} -> {first['final_cost']:.9g}); world 2 "
              f"final cost {rel:.2e} relative from world 1's, {held}")
        if name == "cg":
            gap = float((witness["poses"] - first["poses"]).abs().max())
            out[name]["relabelled_world1_pose_max_diff"] = gap
            out[name]["relabelled_world1_final_cost"] = witness["final_cost"]
            print(f"[parallel] 10b cg: world 2's poses {pose:.3e} from world 1's; the same "
                  f"solve at world 1 with the landmarks relabelled (every sum in another "
                  f"order) {gap:.3e} from them, final cost {witness['final_cost']:.9g}")
        for w, rs in (("world 1", runs), ("world 2", w2[name])):
            r = rs[1]
            print(f"[parallel] 10b {name} {w} (second run): {r['wall_s']:.4f} s, "
                  f"{r['obs_updates_per_s_M']:.3f} M obs-updates/s, peak memory per rank "
                  f"{r['peak_memory_bytes']} B, {r['all_reduce_per_lm_iteration']:.1f} "
                  f"all-reduces per LM iteration")
    return out


def _loop_checks(w1, w2):
    from .smoke_closure import TRAJ_TOL_ALIGNED, _aligned, _same_candidates, flip_band

    lm = w1["loop_min_matches"]
    differ = _same_candidates(w2["candidates"], w1["candidates"],
                              lambda n: abs(n - lm) <= flip_band(n))
    assert w2["edges"] == w1["edges"], f"10c: {w2['edges']} edges, world 1 {w1['edges']}"
    gap = _aligned(w2["closed"], w1["closed"])
    gap_before = _aligned(w2["before"], w1["before"])
    assert gap <= max(TRAJ_TOL_ALIGNED, gap_before), f"10c: trajectories {gap} apart"
    print(f"[parallel] 10c 12-keyframe loop at world 2 (the closure's sweep through the ring, "
          f"K1 fp32) against the world-1 card run (K1 bf16): {w2['edges']} edges on both, "
          f"candidates {len(w2['candidates'])} / {len(w1['candidates'])} (differing "
          f"{differ}), Sim(3)-aligned trajectory gap {gap_before:.2e} before closure, "
          f"{gap:.2e} after")
    return {"edges": w2["edges"], "candidates_differing": differ,
            "aligned_err_before": gap_before, "aligned_err_closed": gap,
            "world2_launches": w2["launches"]}


def _is_cg(name):
    return name.startswith("cg")


def relabelled(problem, seed=0):
    """The same ``BAProblem`` with landmark l renamed perm[l] (a random
    permutation): the same solve, every segment sum in another order."""
    perm = np.random.default_rng(seed).permutation(problem.landmarks.shape[0])
    lm = np.empty_like(problem.landmarks)
    lm[perm] = problem.landmarks
    return problem._replace(landmarks=lm, obs_lm=perm[problem.obs_lm].astype(np.int32))


def ba_problems(cg_size=(512, 131072, 4096), dense_size=(16, 4096), worlds=(1, 2)):
    """10b's problems laid out for each world size, their true poses and
    the relabelled witness: ({world: {"cg": phase 7c's (cameras,
    landmarks, observations per camera) for PCG, "dense" / "cg_window":
    phase 7b's window (cameras, landmarks) for the dense solver / PCG},
    each (sharded, BAConfig, observations)}; {name: (C, 3, 4) tensor};
    (7c's problem relabelled and laid out for one rank, its BAConfig)).
    The defaults are the card's sizes."""
    import niftymatch_torch as nt
    from niftymatch_torch.parallel import partition_by_landmark

    from .smoke_sfm import global_problem, perturbed_problem

    scene_c, problem_c = global_problem(*cg_size)
    scene_w, problem_w = perturbed_problem(*dense_size)
    cfg_c = nt.BAConfig(max_iterations=6, damping=1e-3, cg_iterations=24)
    made = {"cg": (problem_c, cfg_c), "dense": (problem_w, nt.BAConfig()),
            "cg_window": (problem_w, nt.BAConfig())}
    truths = {k: torch.from_numpy((scene_c if k == "cg" else scene_w).poses) for k in made}
    by_world = {w: {k: (partition_by_landmark(p, w), c, int(p.obs_uv.shape[0]))
                    for k, (p, c) in made.items()} for w in worlds}
    return by_world, truths, (partition_by_landmark(relabelled(problem_c), 1), cfg_c)


def run(dev, frames, store, loop_min_matches, loop_min_gap, problems=None):
    """Phase 10a-10c.  ``frames``: 16 640x480 frames on ``dev``;
    ``store``: phase 9b's keyframe store (desc, valid) on ``dev``;
    ``problems``: 10b's (``ba_problems()`` by default).  On the CPU (a
    rehearsal at small sizes) world 1 is gloo and the launch checks and
    the roofline are left out.  Returns (numbers, the launches of 10a's
    world-1 path: ``shard_detect`` and one mutual ring sweep)."""
    import niftymatch_torch as nt
    from niftymatch_torch.geometry.ransac import _gumbel_scores
    from niftymatch_torch.parallel import (
        allpairs_match,
        initialize_distributed,
        ring_allpairs_match,
        spawn,
    )
    from niftymatch_torch.utils import profiling

    from .smoke_closure import _loop12

    cfg = nt.SiftConfig(width=frames.shape[-1], height=frames.shape[-2])
    k_pad = frames.shape[0] - 1
    t0 = time.perf_counter()
    by_world, truths, (witness_problem, witness_cfg) = problems or ba_problems()
    problems1, problems2 = by_world[1], by_world[2]
    cuda = dev.type == "cuda"
    setup_s = time.perf_counter() - t0
    draw = _gumbel_scores(512, 384, 0, torch.device("cpu"))
    numbers = {"note": RING_NOTE, "ba_host_setup_s": setup_s}

    # World 1: NCCL, this process alone.
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed(f"file://{os.path.join(tmp, 'rendezvous')}", 1, 0,
                               "nccl" if cuda else "gloo")
        try:
            w1, mesh, feats = _ring_work(frames, cfg, store, k_pad)
            path_launches = w1["path_launches"]
            # The K1 ring sweep's roofline at the closure's settings (mutual):
            # two products of 2 N^2 D per ordered keyframe pair (forward and
            # backward), each descriptor read once and the counts written.
            K, N, D = feats.desc.shape
            roof = profiling.roofline(
                lambda d, v: ring_allpairs_match(d, v, mesh, ambiguity=0.7, mutual=True).counts,
                [(feats.desc, feats.valid)], flops=4.0 * K * K * N * N * D,
                bytes_accessed=K * N * (D + 1) * 4 + K * K * 4,
                iters=TIMING_REPS) if cuda else None
            ba1 = _ba_work(problems1, mesh)
            refs = {}
            for name, (sharded, bcfg, _) in problems1.items():
                solve = nt.bundle_adjust_cg if _is_cg(name) else nt.bundle_adjust
                solved, stats = solve(nt.BAProblem(*sharded), bcfg, device=dev)
                refs[name] = {"costs": stats.costs.cpu(), "poses": solved.poses.cpu(),
                              "initial_cost": float(stats.initial_cost)}
                del solved, stats
            solved, stats = nt.bundle_adjust_cg(nt.BAProblem(*witness_problem), witness_cfg,
                                                device=dev)
            witness = {"poses": solved.poses.cpu(), "final_cost": float(stats.final_cost)}
            del solved, stats
            loop1 = _loop12(dev, draw)
        finally:
            dist.destroy_process_group()
    oracle, margins = {}, {}
    for name, (desc, valid), amb, mutual in (("plain", feats[-2:], 0.8, False),
                                             ("mutual", feats[-2:], 0.8, True),
                                             ("store", store, 0.7, True)):
        r = allpairs_match(desc, valid, amb, mutual=mutual, return_indices=True)
        oracle[name] = type(r)(r.counts.cpu(), r.indices.cpu())
        margins[name] = margins64(desc, valid, amb).cpu()
    world1_s = time.perf_counter() - t0
    del feats, mesh
    if cuda:
        torch.cuda.empty_cache()

    # World 2: two processes on cuda:0, gloo.
    t0 = time.perf_counter()
    w2 = spawn.run(world2_task, 2, dev.type, frames.cpu(), cfg, tuple(t.cpu() for t in store),
                   k_pad, problems2, draw, backend="gloo", device=dev.type)
    world2_s = time.perf_counter() - t0
    r0, r1 = w2[0], w2[1]
    for key in ("plain", "mutual", "store"):
        assert torch.equal(r0["ring"]["runs"][key]["counts"], r1["ring"]["runs"][key]["counts"])

    worst = _same_features(r0["ring"]["features"], w1["features"], "10a shard_detect world 2")
    K, N = w1["runs"]["mutual"]["indices"].shape[1:]
    print(f"[parallel] 10a shard_detect of {frames.shape[0]} frames and one mutual ring sweep "
          f"({K} x {N}) at world 1: launches {path_launches}; world 2's gathered features "
          f"within {worst:.1e} of world 1's")
    if cuda:
        assert path_launches["k2_orientation_hist"] == path_launches["k3_descriptor"] == 1
        assert r0["loop"]["launches"]["k1_match_top2"] > 0, r0["loop"]["launches"]
    numbers["ring"] = _ring_checks(w1, r0["ring"], oracle, margins, loop_min_matches,
                                   loop_min_gap, cuda)
    numbers["ring"]["world2_path_launches_rank0"] = r0["ring"]["path_launches"]
    numbers["sweep_ms"] = {"world1": w1["sweep_ms"], "world2_rank0": r0["ring"]["sweep_ms"]}
    for w, ms in numbers["sweep_ms"].items():
        print(f"[parallel] 10a ms per sweep, {w}: "
              + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    print(f"[parallel] 10a {RING_NOTE}")
    numbers["roofline"] = dict(vars(roof)) if roof else None
    print(f"[parallel] 10a roofline of the K1 ring sweep ({K} x {N}, mutual, world 1): {roof}")
    numbers["ba"] = _ba_checks(ba1, r0["ba"], refs, truths, witness)
    numbers["loop"] = _loop_checks(loop1, r0["loop"])
    numbers["world1_s"], numbers["world2_s"] = world1_s, world2_s
    print(f"[parallel] world 1 part {world1_s:.1f} s, world 2 spawn and run {world2_s:.1f} s, "
          f"BA problems made on the host in {setup_s:.1f} s")
    return numbers, path_launches
