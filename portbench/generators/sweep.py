"""All-pairs sweeps over a set of described views.

Set-up renders ``frames`` views of a ``landmarks``-point scene (an orbit of
``radius``; ``closed`` makes it the closed loop whose last camera sits
beside the first, else ``arc`` and ``helix``), drawn from the seed, as
uint8 frames, and describes them with the plain reference SIFT at the
configuration's detector: the descriptors are inputs, made by the
benchmark and handed to the program.  A step is one
``parallel.matching.allpairs_match_fused`` of all the views at
``ambiguity``, ``mutual`` and ``precision`` with its indices returned, and
its counts fetched to the host.  The check holds every step's counts and
the indices of the first and last step to the plain reference sweep.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from ..counts import sweep_bound_s
from ..reference import compare, scenes
from ..reference import match as ref_match
from ..reference.sift.pipeline import detect_describe
from . import checks, reference_sift

LOWER = {"fp32": "tf32", "bf16": "fp8"}


def setup(config, mix, seed, device, spans):
    from niftymatch_torch.parallel.matching import allpairs_match_fused

    sift = reference_sift(config)
    arc = scenes.closed_loop_arc(mix["frames"]) if mix["closed"] else tuple(mix["arc"])
    scene = scenes.make_scene(scenes.rng(seed, 1), mix["frames"], mix["landmarks"],
                              mix["radius"], sift.width, sift.height, arc,
                              0.0 if mix["closed"] else mix["helix"])
    frames = scenes.render_frames(scene, scenes.rng(seed, 2), device)
    frames = frames.round().clamp(0, 255)
    desc, valid = [], []
    for c in range(0, frames.shape[0], mix["describe_batch"]):
        f = detect_describe(frames[c:c + mix["describe_batch"]], sift)
        desc.append(f.desc)
        valid.append(f.valid)
        del f
    del frames
    desc, valid = torch.cat(desc).contiguous(), torch.cat(valid).contiguous()
    return SimpleNamespace(sweep=allpairs_match_fused, config=config, mix=mix, device=device,
                           spans=spans, desc=desc, valid=valid, steps=0, counts=[],
                           first=None, last=None, traced=0)


def _sweep(st):
    with st.spans("sweep.allpairs"):
        r = st.sweep(st.desc, st.valid, ambiguity=st.mix["ambiguity"], mutual=st.mix["mutual"],
                     return_indices=True, precision=st.mix["precision"])
    with st.spans("sweep.fetch"):
        counts = r.counts.cpu()
    return counts, r.indices


def warmup(st):
    _sweep(st)


def step(st):
    counts, idx = _sweep(st)
    st.counts.append(counts)
    if st.first is None:
        st.first = idx
    st.last = idx
    if st.spans.on:
        st.traced += 1
    st.steps += 1
    k = st.desc.shape[0]
    return k * (k - 1) // 2


def end_to_end(st, units, elapsed, latencies):
    return {st.mix["rate_metric"]: units / elapsed}


def trace_info(st, trace_cfg):
    k, n, d = st.desc.shape
    return {"steps": st.traced,
            "k1_bound_s": sweep_bound_s(k, n, d, st.mix["precision"])[0] * st.traced}


def release(st):
    """The answers (counts, two index tables) are all the program leaves."""


def reference(st, lower=False):
    """``(counts, indices, sure)`` of the reference sweep: with the mix's
    ``margin``, the float64 sweep and the entries float32 decides
    (``reference.match.allpairs_decided``), else the sweep at the mix's
    precision, every entry counted.  ``lower``: the same sweep one precision
    below the mix's (the control), ``sure`` None."""
    mix = st.mix
    if lower:
        counts, idx = ref_match.allpairs(st.desc, st.valid, mix["ambiguity"], mix["mutual"],
                                         LOWER[mix["precision"]])
        return counts, idx, None
    if "margin" in mix:
        idx, sure = ref_match.allpairs_decided(st.desc, st.valid, mix["ambiguity"],
                                               mix["mutual"], mix["margin"])
        return (idx >= 0).sum(-1, dtype=torch.int32), idx, sure
    counts, idx = ref_match.allpairs(st.desc, st.valid, mix["ambiguity"], mix["mutual"],
                                     mix["precision"])
    return counts, idx, None


def numbers(counts_list, idx_list, ref):
    """The worst ``index_miss`` over ``idx_list`` and ``count_gap`` over
    ``counts_list`` against ``ref`` (``reference``'s triple), and each
    count's gap."""
    ref_counts, ref_idx, sure = ref
    dev = ref_counts.device
    gaps = [compare.count_gap(c.to(dev), ref_counts) for c in counts_list]
    worst = {"index_miss": max(compare.index_miss(i, ref_idx, sure) for i in idx_list),
             "count_gap": max(gaps)}
    return worst, gaps


def check(st):
    if st.first is None:
        return checks({"index_miss": float("inf"), "count_gap": float("inf")}, st.mix), 1
    worst, gaps = numbers(st.counts, [st.first, st.last], reference(st))
    out = checks(worst, st.mix)
    if "count_gap" not in out:
        return out, int(out["index_miss"]["value"] > out["index_miss"]["limit"]) * len(gaps)
    return out, sum(g > out["count_gap"]["limit"] for g in gaps)


def attempted(st):
    return st.steps


def control(st):
    """The sweep one precision below the configuration's (fp32 -> TF32,
    bf16 -> fp8) in the program's place."""
    low_counts, low_idx, _ = reference(st, lower=True)
    return numbers([low_counts], [low_idx], reference(st))[0]


def program_numbers(st):
    return numbers(st.counts, [st.first, st.last], reference(st))[0]
