"""Global bundle adjustment of a scene from several starting estimates.

Set-up makes, from the seed and on the device, the configuration's scene
(``reference.scenes.make_scene``: ``points`` points in the +-2 cube and
``cameras`` cameras on ``turns`` turns of an orbit of ``radius``), its
observation table (``reference.ba.observation_table``: each camera keeps
``max_obs_per_cam`` of the points in its frame, drawn at random), and a
pool of ``pool`` problems, each with its own noise: the table's pixels
moved by ``obs_px``, the true poses by tangents of ``pose_tangent`` (the
first ``fixed_poses`` left at the truth and fixed) and the points by
``points``.  Warm-up solves one problem.  A step is one
``niftymatch_torch.bundle_adjust_cg`` of the configuration's ``BAConfig``
on the next problem of the pool, its initial cost, cost trace and solved
poses fetched to the host; it counts ``cameras`` images.

The check holds every step to the plain float64 reference on the same
problem (``cost0_gap``, ``cost_gap``), and its poses to the truth
(``pose_err``); ``cost1_gap``, the gap in the first LM iteration's cost,
is the median over the pool's problems, each read at its worst step.
"""

from __future__ import annotations

import statistics
from types import SimpleNamespace

import numpy as np
import torch

from ..reference import ba as ref_ba
from ..reference import scenes
from . import checks

NUMBERS = ("cost0_gap", "cost1_gap", "cost_gap", "pose_err")


def _generator(device, seed, *tags):
    """A torch generator on ``device`` for ``seed`` and a stream tag."""
    g = torch.Generator(device=device)
    g.manual_seed(int(scenes.rng(seed, *tags).integers(2**62)))
    return g


def setup(config, mix, seed, device, spans):
    import niftymatch_torch as nt
    from niftymatch_torch.utils.precision import host_fetch

    sc, noise = config["scene"], config["noise"]
    C, L = sc["cameras"], sc["points"]
    arc = (0.0, 2.0 * np.pi * sc["turns"] * (C - 1) / C)
    scene = scenes.make_scene(scenes.rng(seed, 1), C, L, sc["radius"], sc["width"],
                              sc["height"], arc, sc["helix"])
    if list(scene.intrinsics) != sc["intrinsics"]:
        raise ValueError(f"the scene's intrinsics {scene.intrinsics} are not the "
                         f"configuration's {sc['intrinsics']}")
    poses = torch.as_tensor(scene.poses).to(device)
    points = torch.as_tensor(scene.landmarks).to(device)
    intr = torch.as_tensor(scene.intrinsics).to(device)
    uv, cam, lm = ref_ba.observation_table(poses, points, scene.intrinsics, sc["width"],
                                           sc["height"], sc["max_obs_per_cam"],
                                           _generator(device, seed, 2))
    if uv.shape[0] != C * sc["max_obs_per_cam"]:
        raise ValueError(f"{uv.shape[0]} observations, not {C} x {sc['max_obs_per_cam']}: "
                         "a camera sees too few points")
    valid = torch.ones(uv.shape[0], dtype=torch.bool, device=device)
    fixed = torch.zeros(C, dtype=torch.bool, device=device)
    fixed[:sc["fixed_poses"]] = True
    pool = []
    for k in range(mix["pool"]):
        g = _generator(device, seed, 3, k)
        start, pts = ref_ba.perturb(poses, points, sc["fixed_poses"], noise["pose_tangent"],
                                    noise["points"], g)
        obs = uv + noise["obs_px"] * torch.randn(uv.shape, generator=g, device=device)
        pool.append(ref_ba.Problem(start, pts, intr, obs, cam, lm, valid, fixed))
    cfg = nt.BAConfig(**config["ba"])
    return SimpleNamespace(nt=nt, fetch=host_fetch, cfg=cfg, config=config, mix=mix, device=device,
                           spans=spans, truth=poses, pool=pool,
                           answers=[[] for _ in pool], steps=0, traced=0)


def _solve(st, k):
    with st.spans("ba.solve"):
        solved, stats = st.nt.bundle_adjust_cg(st.nt.BAProblem(*st.pool[k]), st.cfg,
                                               device=st.device)
    with st.spans("ba.fetch"):
        return st.fetch(stats.initial_cost, stats.costs, solved.poses)


def warmup(st):
    _solve(st, len(st.pool) - 1)


def step(st):
    k = st.steps % len(st.pool)
    st.answers[k].append(_solve(st, k))
    if st.spans.on:
        st.traced += 1
    st.steps += 1
    return st.config["scene"]["cameras"]


def end_to_end(st, units, elapsed, latencies):
    return {st.mix["rate_metric"]: units / elapsed}


def trace_info(st, trace_cfg):
    return {"steps": st.traced}


def release(st):
    """Nothing to drop: the check solves every problem of the pool again."""


def numbers(answers, ref: ref_ba.Solution, truth) -> dict:
    """The worst of each number over ``answers`` [(initial cost, costs,
    poses)] of one problem against the reference's solution of it;
    infinite without an answer."""
    worst = dict.fromkeys(NUMBERS, 0.0) if answers else dict.fromkeys(NUMBERS, float("inf"))
    truth = truth.double().cpu().numpy()
    for c0, costs, poses in answers:
        gaps = np.abs(costs.astype(np.float64) - ref.costs) / ref.costs
        got = {"cost0_gap": abs(float(c0) - ref.initial_cost) / ref.initial_cost,
               "cost1_gap": float(gaps[0]), "cost_gap": float(gaps.max()),
               "pose_err": float(np.abs(poses.astype(np.float64) - truth).max())}
        for n in NUMBERS:
            worst[n] = max(worst[n], got[n]) if np.isfinite(got[n]) else float("inf")
    return worst


def _worst(st, lower=False, per_step=None):
    """The numbers over the pool's problems: the worst of each over every
    step, except ``cost1_gap``, the median of the problems' worst; with
    ``lower``, the control's answer in place of the program's."""
    per_problem = []
    for k, prob in enumerate(st.pool):
        ref = ref_ba.solve(prob, st.config["ba"])
        if lower:
            low = ref_ba.solve(prob, st.config["ba"], lower=True)
            answers = [(low.initial_cost, low.costs, low.poses.cpu().numpy())]
        else:
            answers = st.answers[k]
        per_problem.append(numbers(answers, ref, st.truth))
        if per_step is not None:
            per_step += [numbers([a], ref, st.truth) for a in answers]
    worst = {n: max(p[n] for p in per_problem) for n in NUMBERS}
    worst["cost1_gap"] = statistics.median(p["cost1_gap"] for p in per_problem)
    return worst


def check(st):
    per_step = []
    out = checks(_worst(st, per_step=per_step), st.mix)
    failed = sum(any(s[n] > out[n]["limit"] for n in NUMBERS) for s in per_step)
    return out, failed or int(not per_step)


def attempted(st):
    return st.steps


def control(st):
    """The reference one precision below (bfloat16 linearisation and costs,
    TF32 products) in the program's place, and ``pose_err_start``: the
    error of the poses the solves start from, what a program that moves
    nothing returns."""
    out = _worst(st, lower=True)
    out["pose_err_start"] = max(
        float((p.poses.double() - st.truth.double()).abs().max()) for p in st.pool)
    return out


def program_numbers(st):
    return _worst(st)
