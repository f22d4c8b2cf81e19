"""Phase 7 of ``chip_smoke.py``: the SfM back-end on the card.

    7a  two-view pose from rendered 640x480 views (render -> detect with K2
        and K3 -> ``estimate_two_view``: K1 twice, E/H-RANSAC, cheirality
        vote, Gauss-Newton polish, triangulation), the card's counterpart of
        the JAX package's ``tests/test_rendered_vo.py``;
    7b  sliding-window dense BA at the SLAM window (5 keyframes x 1,024
        landmarks) and at 16 x 4,096, built as ``tests/test_ba.py`` builds
        its problem, card against the port on the CPU;
    7c  global PCG BA at the 1DSfM scale of ``benchmarks/global_ba_eval.py``
        (512 cameras, 131,072 landmarks, 2,097,152 observations), held to
        the JAX package's costs on the same seeded problem;
    7d  SE(3) and Sim(3) pose graphs at 256 nodes (dense) and the 1,200-node
        Sim(3)-CG graph of ``tests/test_posegraph_sim3.py``.

Every failed check raises.  7b-7d take the sizes they run at (the defaults
are the card's), so the card tests run them small; times and profiles are
CUDA-event and ``torch.profiler`` readings and mean nothing off the card.
"""

from __future__ import annotations

import math
import time
from collections import Counter

import numpy as np
import torch

# Cost of the JAX package's global BA on the same seeded problem at 512 x
# 131,072 (GLOBAL_BA_r05.json, "tpu_single"): costs, not speeds.
JAX_GLOBAL_INITIAL_COST = 26409966.0
JAX_GLOBAL_FINAL_COST = 1866148.125
# The host's waits on the device: a scalar read or a blocking copy
# synchronises the stream (the port calls no device-wide synchronize, so
# the profiler's and this module's own are left out); on the CPU, the
# scalar reads that would be waits on the card.
_SYNC_EVENTS = {"cuda": ("cudaStreamSynchronize", "cudaEventSynchronize"),
                "cpu": ("aten::_local_scalar_dense",)}
# The small-matrix solvers' calls in one estimate_two_view: svd3x3 four times
# in E-RANSAC (the 8-point fit and its essential projection, in the batch
# and the refit), once in each of the two recover_pose and in the
# homography's decomposition; smallest_eigvec in the two 8-point and two
# homography fits and in the three cheirality votes' triangulate_dlt.
TWO_VIEW_SVD3X3 = 7
TWO_VIEW_EIGVEC = 7


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def ms_each(fn, inputs, dev):
    """ms of each ``fn(x)``: CUDA events between consecutive calls on the
    card (no synchronisation between them), the host clock elsewhere."""
    if dev.type != "cuda":
        out = []
        for x in inputs:
            t0 = time.perf_counter()
            fn(x)
            out.append(1e3 * (time.perf_counter() - t0))
        return out
    events = [torch.cuda.Event(enable_timing=True) for _ in range(len(inputs) + 1)]
    events[0].record()
    for x, ev in zip(inputs, events[1:]):
        fn(x)
        ev.record()
    events[-1].synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def _port_frames(event):
    """The innermost three frames of the port in the Python stack of
    ``event`` or of the nearest operator enclosing it."""
    while event is not None:
        frames = [f for f in event.stack if "niftymatch_torch" in f]
        if frames:
            return frames[:3]
        event = event.cpu_parent
    return []


def profile(fn, dev, detail=False):
    """One call of ``fn`` under ``torch.profiler``: device kernels, copies
    and sets apart, summed device ms, and the host's waits on the device.
    Counted from the raw trace events (building the profiler's event tree
    takes minutes at the ~200,000 kernels of a SLAM chunk).  With
    ``detail``, also print the time by operator (largest first) and each
    host wait with the port's frames that caused it."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    _sync(dev)
    with tprofile(activities=acts, with_stack=detail) as prof:
        fn()
        _sync(dev)
    if detail:
        sort = "cuda_time_total" if dev.type == "cuda" else "cpu_time_total"
        print(prof.key_averages().table(sort_by=sort, row_limit=25, max_name_column_width=60))
        waits = [e for e in prof.events() if e.name in _SYNC_EVENTS[dev.type]]
        for (name, frames), n in Counter(
                (e.name, " <- ".join(_port_frames(e))) for e in waits).most_common():
            print(f"  wait {n:5d} x {name}: {frames}")
    raw = prof.profiler.kineto_results.events()
    # A record_function region is drawn on the device's timeline too: not an op.
    gpu = [e for e in raw if e.device_type() == torch.autograd.DeviceType.CUDA
           and not e.is_user_annotation()]
    copies = sum(1 for e in gpu if e.name().startswith(("Memcpy", "Memset")))
    return {"kernels": len(gpu) - copies, "copies_and_sets": copies,
            "device_ms": sum(e.duration_ns() for e in gpu) / 1e6,
            "host_syncs": sum(1 for e in raw if e.name() in _SYNC_EVENTS[dev.type])}


def _per_iteration(one, two):
    """What one more LM iteration adds: profile(2 iterations) - profile(1)."""
    return {k: two[k] - one[k] for k in one}


def _rel_pose(T_a, T_b):
    """(R, t) of camera b with camera a as the world frame (float64)."""
    Ra, ta = T_a[:, :3].astype(np.float64), T_a[:, 3].astype(np.float64)
    Rb, tb = T_b[:, :3].astype(np.float64), T_b[:, 3].astype(np.float64)
    R = Rb @ Ra.T
    return R, tb - R @ ta


def _angle_deg(R):
    return math.degrees(math.acos(float(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0))))


# -- 7a ---------------------------------------------------------------------


def two_view_phase(dev):
    """``tests/test_rendered_vo.py`` at 640x480: 8 rendered views of 1,200
    landmarks, 2,048 features a view, pairs (0,1), (1,2), (2,3) through
    ``estimate_two_view`` at 1,024 RANSAC iterations."""
    import niftymatch_torch as nt
    from niftymatch_torch.data import make_scene, render_frames
    from niftymatch_torch.kernels import _build

    pairs = 3
    scene = make_scene(num_cams=8, num_landmarks=1200, seed=0, radius=6.0,
                       width=640, height=480)
    frames = render_frames(scene, seed=0)
    cfg = nt.SiftConfig(width=640, height=480, max_features=2048)
    rcfg = nt.RansacConfig(iterations=1024, inlier_threshold=4.0)
    intr = tuple(float(v) for v in scene.intrinsics)
    fx, fy, cx, cy = intr

    _sync(dev)
    _build.reset_launches()
    feats = nt.detect_and_describe_batch(frames, cfg, device=dev)
    _sync(dev)
    detect_launches = dict(_build.LAUNCHES)
    one = [nt.Features(*[t[i] for t in feats]) for i in range(8)]

    rows, r_errs, pair_launches = [], [], []
    for i in range(pairs):
        _build.reset_launches()
        tv = nt.estimate_two_view(one[i], one[i + 1], intr, rcfg, device=dev)
        _sync(dev)
        pair_launches.append(dict(_build.LAUNCHES))
        R_true, t_true = _rel_pose(scene.poses[i], scene.poses[i + 1])
        R, t = tv.R.double().cpu().numpy(), tv.t.double().cpu().numpy()
        n_inl, ok = int(tv.num_inliers), bool(tv.success)
        r_err = float(np.abs(R - R_true).max())
        t_deg = math.degrees(math.acos(float(np.clip(
            t @ t_true / max(np.linalg.norm(t_true), 1e-12), -1.0, 1.0))))
        # Reprojection of the triangulated points (A's frame, unit scale)
        # against the matched keypoints, in both views.
        pv = tv.point_valid.cpu().numpy()
        X = tv.points.double().cpu().numpy()[pv]
        idx = tv.matches.indices.cpu().numpy()[pv]
        xa = np.stack([one[i].x.cpu().numpy()[pv], one[i].y.cpu().numpy()[pv]], -1)
        xb = np.stack([one[i + 1].x.cpu().numpy()[idx], one[i + 1].y.cpu().numpy()[idx]], -1)
        Xb = X @ R.T + t
        err_a = np.hypot(fx * X[:, 0] / X[:, 2] + cx - xa[:, 0], fy * X[:, 1] / X[:, 2] + cy - xa[:, 1])
        err_b = np.hypot(fx * Xb[:, 0] / Xb[:, 2] + cx - xb[:, 0],
                         fy * Xb[:, 1] / Xb[:, 2] + cy - xb[:, 1])
        share = float(((err_a < 2.0) & (err_b < 2.0)).mean()) if len(X) else 0.0
        good = ok and n_inl >= 20
        if good:
            r_errs.append(r_err)
        rows.append({"pair": [i, i + 1], "success": ok, "inliers": n_inl,
                     "matches": int((tv.matches.indices >= 0).sum()),
                     "max_abs_R_err": r_err, "rot_err_deg": _angle_deg(R @ R_true.T),
                     "t_angle_deg": t_deg, "points_valid": int(pv.sum()),
                     "reproj_under_2px_share": share})
        print(f"[sfm] 7a pair ({i}, {i + 1}): success {ok}, {n_inl} inliers, rotation "
              f"{rows[-1]['rot_err_deg']:.3f} deg off (max |R - R_true| {r_err:.4f}), t "
              f"{t_deg:.2f} deg off, {int(pv.sum())} points, {share:.3f} reproject "
              f"within 2 px in both views; launches {pair_launches[-1]}")
    print(f"[sfm] 7a detection of the {len(one)} frames: launches {detect_launches}")
    assert len(r_errs) >= 2, f"only {len(r_errs)} of {pairs} pairs succeeded"
    assert float(np.median(r_errs)) < 0.2, r_errs
    if dev.type == "cuda":
        assert detect_launches == {"k1_match_top2": 0, "k1_match_top2_bf16": 0,
                                   "k2_orientation_hist": 1, "k3_descriptor": 1,
                                   "refine_gn": 0, "svd3x3": 0, "smallest_eigvec": 0}, \
            "detection of the batch did not launch K2 and K3 once"
        assert all(la == {"k1_match_top2": 2, "k1_match_top2_bf16": 0,
                          "k2_orientation_hist": 0, "k3_descriptor": 0, "refine_gn": 1,
                          "svd3x3": TWO_VIEW_SVD3X3, "smallest_eigvec": TWO_VIEW_EIGVEC}
                   for la in pair_launches), \
            ("estimate_two_view did not launch K1 twice, the polish once and the "
             "small-matrix solvers once a call")

    calls = [(one[i], one[i + 1]) for i in range(pairs)]
    times = ms_each(lambda ab: nt.estimate_two_view(*ab, intr, rcfg, device=dev), calls, dev)
    prof = profile(lambda: nt.estimate_two_view(one[0], one[1], intr, rcfg, device=dev), dev)
    print(f"[sfm] 7a estimate_two_view: {times} ms (median {np.median(times):.3f}); one "
          f"call: {prof}")
    return {"pairs": rows, "median_max_abs_R_err": float(np.median(r_errs)),
            "detect_launches": detect_launches, "pair_launches": pair_launches,
            "two_view_ms": times, "two_view_ms_median": float(np.median(times)),
            "two_view_profile": prof}


# -- 7b ---------------------------------------------------------------------


def perturbed_problem(C, L, noise_px=0.0, pose_noise=0.02, radius=6.0, arc=(-0.5, 0.5),
                      max_obs_per_cam=None):
    """``tests/test_ba.py``'s problem (seed 0) at C x L (or, with the
    arguments of ``benchmarks/global_ba_eval.py``, its problem): noisy
    poses (the first two fixed) and landmarks (noise 0.05) around
    ``make_scene``'s truth, as numpy and CPU tensors; returns (scene,
    BAProblem)."""
    from niftymatch_torch.data import make_observation_table, make_scene
    from niftymatch_torch.sfm import BAProblem, se3_compose, se3_exp

    scene = make_scene(num_cams=C, num_landmarks=L, seed=0, radius=radius, arc=arc)
    obs = make_observation_table(scene, seed=0, noise_px=noise_px,
                                 max_obs_per_cam=max_obs_per_cam)
    rng = np.random.default_rng(7)
    xi = rng.normal(0, pose_noise, size=(C, 6)).astype(np.float32)
    xi[:2] = 0
    poses = se3_compose(se3_exp(torch.from_numpy(xi)), torch.from_numpy(scene.poses))
    lms = scene.landmarks + rng.normal(0, 0.05, size=scene.landmarks.shape).astype(np.float32)
    fixed = np.zeros(C, bool)
    fixed[:2] = True
    return scene, BAProblem(poses, lms, scene.intrinsics, *obs, fixed)


def window_ba_phase(dev, sizes=((5, 1024), (16, 4096)), reps=5):
    import niftymatch_torch as nt
    from niftymatch_torch.utils.precision import state_to

    cfg = nt.BAConfig()
    out = {}
    for C, L in sizes:
        scene, problem = perturbed_problem(C, L)
        problem = state_to(problem, dev)
        solved, st = nt.bundle_adjust(problem, cfg, device=dev)
        c0, c1 = float(st.initial_cost), float(st.final_cost)
        pose_err = float(np.abs(solved.poses.cpu().numpy() - scene.poses).max())
        lm_err = float(np.abs(solved.landmarks.cpu().numpy() - scene.landmarks).max())
        key = f"{C}x{L}"
        out[key] = {"observations": int(problem.obs_uv.shape[0]), "initial_cost": c0,
                    "final_cost": c1, "max_pose_err": pose_err, "max_landmark_err": lm_err}
        if (C, L) == sizes[0]:
            # The card against the port on the CPU (the first size only: the
            # CPU takes tens of seconds at the second): the cost trace within
            # 1e-3 relative, the fp32 floor of a noise-free problem (costs
            # below 1e-7 of the start) counting as equal.
            _, st_cpu = nt.bundle_adjust(state_to(problem, "cpu"), cfg, device="cpu")
            costs, costs_cpu = st.costs.cpu().numpy(), st_cpu.costs.numpy()
            gap = float(np.max(np.abs(costs - costs_cpu)
                               / np.maximum(np.maximum(costs, costs_cpu), 1e-4 * c0)))
            out[key].update(final_cost_cpu=float(st_cpu.final_cost), cost_trace_gap_vs_cpu=gap)
            assert gap <= 1e-3, f"{key}: card and CPU cost traces differ"
        inputs = [problem._replace(landmarks=problem.landmarks + 1e-4 * (k + 1))
                  for k in range(reps + 1)]
        times = ms_each(lambda p: nt.bundle_adjust(p, cfg, device=dev), inputs, dev)[1:]
        out[key].update(ms=times, ms_median=float(np.median(times)))
        print(f"[sfm] 7b bundle_adjust {key}: {out[key]}")
        assert c1 < 1e-3 * c0, f"{key}: cost did not fall 1000x"
        assert pose_err <= 2e-3 and lm_err <= 5e-3, f"{key}: not at the truth"
        if (C, L) == sizes[0]:
            one = profile(lambda: nt.bundle_adjust(problem, nt.BAConfig(max_iterations=1),
                                                   device=dev), dev)
            two = profile(lambda: nt.bundle_adjust(problem, nt.BAConfig(max_iterations=2),
                                                   device=dev), dev)
            out[key]["per_lm_iteration"] = _per_iteration(one, two)
            print(f"[sfm] 7b one LM iteration at {key}: {out[key]['per_lm_iteration']}")
    return out


# -- 7c ---------------------------------------------------------------------


def global_problem(cams=512, landmarks=131072, obs_per_cam=4096):
    """``benchmarks/global_ba_eval.py``'s problem: (scene, BAProblem)."""
    return perturbed_problem(
        cams, landmarks, noise_px=1.0, pose_noise=0.01, radius=8.0,
        arc=(0.0, 2 * np.pi * (cams - 1) / cams), max_obs_per_cam=obs_per_cam)


def global_ba_phase(dev, cams=512, landmarks=131072, obs_per_cam=4096, check_jax_costs=True):
    """``benchmarks/global_ba_eval.py --cams 512 --landmarks 131072 --solver
    cg --iterations 6 --cg-iterations 24`` on one card: one warm-up run,
    then one timed run on landmarks + 1e-4 (distinct inputs)."""
    import niftymatch_torch as nt
    from niftymatch_torch.utils.precision import state_to

    iterations, cg_iterations = 6, 24
    t0 = time.perf_counter()
    scene, problem = global_problem(cams, landmarks, obs_per_cam)
    problem = state_to(problem, dev)
    setup_s = time.perf_counter() - t0
    O = int(problem.obs_uv.shape[0])
    cfg = nt.BAConfig(max_iterations=iterations, damping=1e-3, cg_iterations=cg_iterations)
    nt.bundle_adjust_cg(problem, cfg, device=dev)
    timed = problem._replace(landmarks=problem.landmarks + 1e-4)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solved, st = nt.bundle_adjust_cg(timed, cfg, device=dev)
    _sync(dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    c0, c1 = float(st.initial_cost), float(st.final_cost)
    pose_err = float(np.abs(solved.poses.cpu().numpy() - scene.poses).max())
    rate = O * 6 / wall / 1e6
    one = profile(lambda: nt.bundle_adjust_cg(
        timed, nt.BAConfig(max_iterations=1, damping=1e-3, cg_iterations=cg_iterations),
        device=dev), dev)
    two = profile(lambda: nt.bundle_adjust_cg(
        timed, nt.BAConfig(max_iterations=2, damping=1e-3, cg_iterations=cg_iterations),
        device=dev), dev)
    per_it = _per_iteration(one, two)
    print(f"[sfm] 7c bundle_adjust_cg {cams} cams x {landmarks} landmarks, {O} obs "
          f"({setup_s:.1f} s to make on the host): cost {c0:.9g} -> {c1:.9g}, max pose "
          f"err {pose_err:.4f}; wall {wall:.4f} s, {rate:.3f} M obs-updates/s, peak "
          f"memory {peak} B; one LM iteration: {per_it}; costs {st.costs.tolist()}")
    assert c1 < 0.1 * c0, "global BA did not cut the cost 10x"
    assert pose_err <= 0.25, "global BA poses are off"
    if check_jax_costs:
        assert abs(c0 - JAX_GLOBAL_INITIAL_COST) <= 1e-3 * JAX_GLOBAL_INITIAL_COST, \
            "initial cost differs from the JAX package's"
        assert abs(c1 - JAX_GLOBAL_FINAL_COST) <= 0.02 * JAX_GLOBAL_FINAL_COST, \
            "final cost differs from the JAX package's"
    return {"cams": cams, "landmarks": landmarks, "observations": O,
            "lm_iterations": iterations, "cg_iterations": cg_iterations,
            "initial_cost": c0, "final_cost": c1, "costs": st.costs.tolist(),
            "max_pose_err": pose_err, "wall_s": wall, "obs_updates_per_s_M": rate,
            "peak_memory_bytes": peak, "host_setup_s": setup_s,
            "per_lm_iteration": per_it, "run_1_iteration": one}


# -- 7d ---------------------------------------------------------------------


def _look_at_circle(n, radius=5.0):
    from niftymatch_torch.data.synthetic import _look_at

    poses = []
    for k in range(n):
        a = 2 * np.pi * k / n
        poses.append(_look_at(np.array([radius * np.sin(a), 0.0, -radius * np.cos(a)]),
                              np.zeros(3)))
    return np.stack(poses).astype(np.float32)


def _compose(a, b):
    from niftymatch_torch.sfm import se3_compose

    return se3_compose(torch.from_numpy(np.asarray(a, np.float32)),
                       torch.from_numpy(np.asarray(b, np.float32))).numpy()


def _rel(a, b):
    """T_a T_b^-1 (numpy, float32 through the port's SE(3))."""
    from niftymatch_torch.sfm import se3_inverse

    return _compose(a, se3_inverse(torch.from_numpy(np.asarray(b, np.float32))).numpy())


def drifted_odometry(gt, gamma):
    """Dead-reckoned poses whose step k carries scale drift gamma^(k+1)
    (``tests/test_posegraph_sim3.py::_drifted_loop``)."""
    drifted = [gt[0]]
    for k in range(len(gt) - 1):
        Z = _rel(gt[k + 1], gt[k])
        Z[:, 3] *= gamma ** (k + 1)
        drifted.append(_compose(Z, drifted[-1]))
    return np.stack(drifted).astype(np.float32)


def sim3_loop_graph(n, gamma, anchors, loop_weight=10.0):
    """Odometry chain over ``drifted_odometry`` plus loop edges (i -> 0),
    i in ``anchors``, each the true relative pose in node i's local scale
    with relative scale gamma^i; returns (gt, Sim3Graph)."""
    from niftymatch_torch.sfm import Sim3Graph

    gt = _look_at_circle(n)
    drifted = drifted_odometry(gt, gamma)
    ei, ej = list(range(1, n)), list(range(0, n - 1))
    Zs = [_rel(drifted[i], drifted[j]) for i, j in zip(ei, ej)]
    es, w = [1.0] * (n - 1), [1.0] * (n - 1)
    for i in anchors:
        Z = _rel(gt[i], gt[0])
        Z[:, 3] *= gamma ** i
        ei.append(i)
        ej.append(0)
        Zs.append(Z)
        es.append(gamma ** i)
        w.append(loop_weight)
    fixed = np.zeros(n, bool)
    fixed[0] = True
    E = len(ei)
    return gt, Sim3Graph(
        scale=np.ones(n, np.float32), poses=drifted, edge_i=np.asarray(ei, np.int32),
        edge_j=np.asarray(ej, np.int32), edge_s=np.asarray(es, np.float32),
        edge_T=np.stack(Zs).astype(np.float32), edge_weight=np.asarray(w, np.float32),
        edge_valid=np.ones(E, bool), node_fixed=fixed)


def se3_chain_graph(n, drift=0.08, seed=42):
    """``tests/test_posegraph_metrics.py::_chain_graph`` at n nodes: a random
    chain, odometry with se3_exp(N(0, drift)) noise, exact loop edges
    (n-1 -> 0, n/2 -> 0) of weight 10; dead-reckoned initial poses.
    Returns (gt, PoseGraph)."""
    from niftymatch_torch.sfm import PoseGraph, se3_exp

    rng = np.random.default_rng(seed)
    xi_gt = rng.normal(0, 0.3, size=(n, 6)).astype(np.float32)
    gt = [np.eye(3, 4, dtype=np.float32)]
    for i in range(1, n):
        gt.append(_compose(se3_exp(torch.from_numpy(xi_gt[i] * 0.3)).numpy(), gt[-1]))
    gt = np.stack(gt)
    ei, ej, Zs, w = [], [], [], []
    for i in range(n - 1):
        noise = se3_exp(torch.from_numpy(rng.normal(0, drift, 6).astype(np.float32))).numpy()
        ei.append(i + 1)
        ej.append(i)
        Zs.append(_compose(noise, _rel(gt[i + 1], gt[i])))
        w.append(1.0)
    for a in (n - 1, n // 2):
        ei.append(a)
        ej.append(0)
        Zs.append(_rel(gt[a], gt[0]))
        w.append(10.0)
    init = [np.eye(3, 4, dtype=np.float32)]
    for e in range(n - 1):
        init.append(_compose(Zs[e], init[-1]))
    fixed = np.zeros(n, bool)
    fixed[0] = True
    return gt, PoseGraph(
        poses=np.stack(init), edge_i=np.asarray(ei, np.int32), edge_j=np.asarray(ej, np.int32),
        edge_T=np.stack(Zs), edge_weight=np.asarray(w, np.float32),
        edge_valid=np.ones(len(ei), bool), node_fixed=fixed)


def _centers(poses, scale=None):
    from niftymatch_torch.sfm.se3 import camera_center

    T = torch.as_tensor(np.asarray(poses, np.float32)).clone()
    if scale is not None:
        T[:, :, 3] /= torch.as_tensor(np.asarray(scale, np.float32))[:, None]
    return camera_center(T).numpy()


def _timed_graph_calls(fn, graph, dev, reps):
    """ms of ``reps`` calls of ``fn`` on distinct inputs (every non-fixed
    node's translation moved by 1e-6 k)."""
    from niftymatch_torch.utils.precision import state_to

    g = state_to(graph, dev)
    move = (~g.node_fixed).to(torch.float32)[:, None] * 1e-6
    inputs = []
    for k in range(1, reps + 1):
        poses = g.poses.clone()
        poses[:, :, 3] += k * move
        inputs.append(g._replace(poses=poses))
    return ms_each(fn, inputs, dev)


def pose_graph_phase(dev, dense_nodes=256, cg_nodes=1200, reps=3):
    from niftymatch_torch.sfm import (
        optimize_pose_graph,
        optimize_pose_graph_sim3,
        optimize_pose_graph_sim3_cg,
    )
    from niftymatch_torch.utils.metrics import ate_rmse

    out = {}
    # SE(3), dense, the metrics test's chain at dense_nodes.
    gt, g = se3_chain_graph(dense_nodes)
    res, st = optimize_pose_graph(g, iterations=12, damping=1e-4, device=dev)
    before = ate_rmse(_centers(g.poses), _centers(gt), with_scale=False)
    after = ate_rmse(_centers(res.poses.cpu()), _centers(gt), with_scale=False)
    times = _timed_graph_calls(
        lambda x: optimize_pose_graph(x, iterations=12, damping=1e-4, device=dev), g, dev, reps)
    out["se3_dense"] = {"nodes": dense_nodes, "initial_cost": float(st.initial_cost),
                        "final_cost": float(st.final_cost), "ate_before": before,
                        "ate_after": after, "ms": times}
    print(f"[sfm] 7d SE(3) dense, {dense_nodes} nodes: {out['se3_dense']}")
    assert float(st.final_cost) <= 0.5 * float(st.initial_cost), "SE(3) cost not halved"
    assert after < before, "SE(3) ATE did not fall"

    # Sim(3), dense with Huber (the SLAM system's loop closure settings),
    # the scale-drift test's loop at dense_nodes: the same total drift as
    # 1.06 over its 12 nodes, spread over the longer loop.
    gamma = 1.06 ** (11.0 / (dense_nodes - 1))
    gt, g = sim3_loop_graph(dense_nodes, gamma, anchors=[dense_nodes - 1])
    kw = dict(iterations=20, damping=1e-4, huber_delta=1.0)
    res, st = optimize_pose_graph_sim3(g, **kw, device=dev)
    before = ate_rmse(_centers(g.poses), _centers(gt))
    after = ate_rmse(_centers(res.poses.cpu(), res.scale.cpu()), _centers(gt))
    times = _timed_graph_calls(lambda x: optimize_pose_graph_sim3(x, **kw, device=dev),
                               g, dev, reps)
    out["sim3_dense_huber"] = {"nodes": dense_nodes, "gamma": gamma,
                               "initial_cost": float(st.initial_cost),
                               "final_cost": float(st.final_cost), "ate_before": before,
                               "ate_after": after, "ms": times}
    print(f"[sfm] 7d Sim(3) dense + Huber, {dense_nodes} nodes: {out['sim3_dense_huber']}")
    assert float(st.final_cost) <= 0.05 * float(st.initial_cost), "Sim(3) cost not cut 95 %"
    assert after < before, "Sim(3) ATE did not fall"

    # Sim(3)-CG at cg_nodes: ``test_sim3_cg_scales_to_1000_nodes``.
    gamma = 1.002
    anchors = list(range(60, cg_nodes, 60)) + [cg_nodes - 1]
    gt, g = sim3_loop_graph(cg_nodes, gamma, anchors)
    kw = dict(iterations=40, damping=1e-4, cg_iterations=192)
    res, st = optimize_pose_graph_sim3_cg(g, **kw, device=dev)
    drift = gamma ** np.arange(cg_nodes)
    ratio = res.scale.cpu().numpy() / drift
    profile_err = float(np.abs(np.log(ratio / ratio[0])).max())
    times = _timed_graph_calls(lambda x: optimize_pose_graph_sim3_cg(x, **kw, device=dev),
                               g, dev, 1)
    out["sim3_cg"] = {"nodes": cg_nodes, "edges": int(g.edge_i.shape[0]),
                      "initial_cost": float(st.initial_cost),
                      "final_cost": float(st.final_cost),
                      "log_scale_profile_err": profile_err, "ms": times}
    print(f"[sfm] 7d Sim(3)-CG, {cg_nodes} nodes: {out['sim3_cg']}")
    assert float(st.final_cost) < 0.05 * float(st.initial_cost), "Sim(3)-CG cost not cut 95 %"
    assert profile_err < 0.2, "Sim(3)-CG scale profile is off"
    return out


def run(dev):
    """Every part of phase 7 at the card's sizes."""
    return {"two_view": two_view_phase(dev), "window_ba": window_ba_phase(dev),
            "global_ba": global_ba_phase(dev), "pose_graphs": pose_graph_phase(dev)}
