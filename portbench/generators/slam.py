"""SLAM tracking sessions over a rendered clip.

Set-up renders a clip of ``frames`` uint8 frames of a ``landmarks``-point
scene on an orbit of ``radius`` (``arc``, ``helix``), drawn from the seed,
and keeps it on the host as a camera would deliver it.  Warm-up runs the
first chunk of a throwaway session.  A step is one chunk of a session:
``SlamSystem.process_frames`` over the next ``chunk_size`` frames (the
first chunk of a session also takes its first frame); a session is a fresh
``SlamSystem`` over the whole clip, ended by ``flush_ba``, and sessions run
back to back.

The check holds each session the window ran (of at least ``min_frames``
frames) to the scene's true poses: the Sim(3)-aligned keyframe trajectory
against the true centres of the same frames (``ate_share``), and the share
of frames not taken as keyframes (``reject_share``).  ``check_keyframes``
keyframes of the first session, drawn from the seed, have their stored
features held to the plain reference SIFT on the same frames.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..reference import compare, scenes
from ..reference.compare import FIELDS
from ..reference.sift.pipeline import detect_describe
from . import checks, reference_sift



def _slam_config(config, scene):
    from niftymatch_torch.config import BAConfig, RansacConfig
    from niftymatch_torch.slam import SlamConfig

    s = dict(config["slam"])
    s["ransac"] = RansacConfig(**s["ransac"])
    if "ba" in s:
        s["ba"] = BAConfig(**s["ba"])
    s["intrinsics"] = tuple(float(v) for v in scene.intrinsics)
    return SlamConfig(**s)


def setup(config, mix, seed, device, spans):
    from niftymatch_torch.slam import SlamSystem

    sift = config["sift"]
    scene = scenes.make_scene(scenes.rng(seed, 1), mix["frames"], mix["landmarks"],
                              mix["radius"], sift["width"], sift["height"],
                              tuple(mix["arc"]), mix["helix"])
    frames = scenes.render_frames(scene, scenes.rng(seed, 2), device)
    clip = frames.round().clamp(0, 255).to(torch.uint8).cpu().numpy()
    del frames
    cfg = _slam_config(config, scene)
    gen = scenes.rng(seed, 3)
    return SimpleNamespace(SlamSystem=SlamSystem, cfg=cfg, config=config, mix=mix,
                           device=device, spans=spans, scene=scene, clip=clip, gen=gen,
                           system=None, pos=0, sessions=[], frames_done=0,
                           traced_frames=0)


def _chunk_bounds(st):
    n = st.cfg.chunk_size + (1 if st.pos == 0 else 0)
    return st.pos, min(st.pos + n, len(st.clip))


def warmup(st):
    system = st.SlamSystem(st.cfg, device=st.device)
    system.process_frames(st.clip[:st.cfg.chunk_size + 1])
    system.flush_ba()


def step(st):
    if st.system is None:
        with st.spans("slam.session_start"):
            st.system = st.SlamSystem(st.cfg, device=st.device)
        st.pos = 0
        st.sessions.append({"system": st.system, "infos": [], "fed": 0})
    lo, hi = _chunk_bounds(st)
    with st.spans("slam.process_frames"):
        infos = st.system.process_frames(st.clip[lo:hi])
    st.sessions[-1]["infos"].extend(infos)
    st.sessions[-1]["fed"] += hi - lo
    st.pos = hi
    if hi == len(st.clip):
        with st.spans("slam.flush_ba"):
            st.system.flush_ba()
        st.system = None
    if st.spans.on:
        st.traced_frames += hi - lo
    st.frames_done += hi - lo
    return hi - lo


def end_to_end(st, units, elapsed, latencies):
    return {st.mix["rate_metric"]: units / elapsed}


def trace_info(st, trace_cfg):
    return {"steps": trace_cfg["steps"], "frames": st.traced_frames}


def release(st):
    """Keep each session's keyframe poses, frame flags and the sampled
    keyframes' features; drop the systems."""
    first = True
    for s in st.sessions:
        system, infos = s.pop("system"), s["infos"]
        s["flags"] = np.array([bool(i["keyframe"]) for i in infos])
        s["poses"] = system.poses() if system.keyframes else np.zeros((0, 3, 4))
        if first:
            kf_frames = np.nonzero(s["flags"])[0]
            n = min(st.mix["check_keyframes"], len(kf_frames))
            pick = sorted(int(k) for k in st.gen.choice(len(kf_frames), n, replace=False))
            s["sampled"] = [(int(kf_frames[k]), {
                name: getattr(system.keyframes[k].feats, name).clone()[None]
                for name in FIELDS}) for k in pick]
            first = False
    st.system = None


def session_numbers(st, s):
    """ate_share and reject_share of one released session: a frame fed
    without an answer counts as rejected, and answers that cannot be told
    apart frame by frame (fewer than fed, or keyframes without a pose)
    leave no trajectory to compare."""
    flags = s["flags"]
    kf_frames = np.nonzero(flags)[0]
    reject = 1.0 - len(kf_frames) / max(s["fed"], 1)
    if len(flags) != s["fed"] or len(kf_frames) != len(s["poses"]):
        return {"ate_share": float("inf"), "reject_share": reject}
    true = compare.centres(st.scene.poses[kf_frames])
    est = compare.centres(s["poses"])
    return {"ate_share": compare.ate_share(est, true), "reject_share": reject}


def feature_numbers(st, sampled, lower=False):
    cfg = reference_sift(st.config)
    worst = {"kp_miss": 0.0, "desc_miss": 0.0}
    for frame, feats in sampled:
        img = torch.as_tensor(st.clip[frame:frame + 1]).to(st.device).to(torch.float32)
        ref = detect_describe(img, cfg)
        got = feats
        if lower:
            low = detect_describe(img, cfg, lower=True)
            got = {name: getattr(low, name) for name in FIELDS}
        g, _ = compare.feature_gaps(got, {name: getattr(ref, name) for name in FIELDS})
        for n in worst:
            worst[n] = max(worst[n], g[n])
    return worst


def check(st):
    values = {"ate_share": 0.0, "reject_share": 0.0}
    failed = 0
    judged = [s for s in st.sessions if s["fed"] >= st.mix["min_frames"]] or st.sessions[:1]
    lim = checks({**values, "kp_miss": 0.0, "desc_miss": 0.0}, st.mix)
    for s in judged:
        got = session_numbers(st, s)
        for n in values:
            values[n] = max(values[n], got[n])
        failed += any(got[n] > lim[n]["limit"] for n in got)
    if st.sessions:
        values.update(feature_numbers(st, st.sessions[0]["sampled"]))
    else:
        values.update(kp_miss=float("inf"), desc_miss=float("inf"))
    return checks(values, st.mix), failed


def attempted(st):
    return st.frames_done


def control(st):
    """The control for the features: the reference SIFT with its pyramid in
    bfloat16, in the program's place on the sampled keyframes."""
    return feature_numbers(st, st.sessions[0]["sampled"], lower=True)


def program_numbers(st):
    values = session_numbers(st, st.sessions[0])
    values.update(feature_numbers(st, st.sessions[0]["sampled"]))
    return values

