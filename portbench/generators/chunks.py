"""Chunks of image pairs through detect + describe + match.

A step is one chunk of ``pairs`` image pairs (a scene of ``blobs`` Gaussian
blobs and the same scene shifted by ``shift`` px): ``detect_and_describe_batch``
of its 2 * ``pairs`` images, one batched ``match_pair`` of A against B at
``ambiguity`` and ``precision``, and the match indices fetched to the host.
The inputs are a pool of ``pool`` distinct chunks made on the device from
the seed and cycled.  ``check_chunks`` pool chunks, drawn from the seed,
are checked: the features of their first step and the indices of every
step that ran them, against the plain reference on the same images.
"""

from __future__ import annotations

import contextlib
import importlib
from types import SimpleNamespace


from ..counts import k3_bound_s
from ..reference import compare, scenes
from ..reference.compare import FIELDS
from ..reference import match as ref_match
from ..reference.sift.pipeline import detect_describe
from . import checks, program_sift, reference_sift



def setup(config, mix, seed, device, spans):
    import niftymatch_torch as nt

    sift = program_sift(config)
    h, w = sift.height, sift.width
    pool = [scenes.shifted_pairs(h, w, scenes.rng(seed, 1, c), mix["pairs"], mix["blobs"],
                                 mix["shift"], device) for c in range(mix["pool"])]
    gen = scenes.rng(seed, 2)
    sampled = sorted(int(k) for k in gen.choice(mix["pool"], mix["check_chunks"], replace=False))
    return SimpleNamespace(nt=nt, config=config, mix=mix, sift=sift, device=device, spans=spans,
                           pool=pool, sampled=sampled, steps=0, feats={}, indices={k: [] for k in sampled},
                           traced=[])


def _chunk(st, imgs):
    nt = st.nt
    p = st.mix["pairs"]
    with st.spans("chunk.detect_describe"):
        f = nt.detect_and_describe_batch(imgs, st.sift, device=st.device)
    with st.spans("chunk.match"):
        a = nt.Features(*[t[:p] for t in f])
        b = nt.Features(*[t[p:] for t in f])
        m = nt.match_pair(a, b, st.mix["ambiguity"], st.mix["precision"], device=st.device)
    with st.spans("chunk.fetch"):
        idx = m.indices.cpu()
    return f, idx


def warmup(st):
    _chunk(st, st.pool[-1])


def step(st):
    k = st.steps % len(st.pool)
    f, idx = _chunk(st, st.pool[k])
    if k in st.indices:
        st.indices[k].append(idx)
        if k not in st.feats:
            st.feats[k] = {name: getattr(f, name) for name in FIELDS}
    if st.spans.on:
        st.traced.append(k)
    st.steps += 1
    return 2 * st.mix["pairs"]


def end_to_end(st, units, elapsed, latencies):
    from ..harness import p95

    return {st.mix["rate_metric"]: units / elapsed,
            st.mix["tail_metric"]: 1e3 * p95(latencies)}


@contextlib.contextmanager
def trace_hooks(st):
    """Spans around the front end and the describe stage of each chunk."""
    sift = importlib.import_module("niftymatch_torch.sift")
    orig = sift.keypoints_and_planes, sift.describe_keypoints

    def front_end(*a, **k):
        with st.spans("chunk.front_end"):
            return orig[0](*a, **k)

    def describe(*a, **k):
        with st.spans("chunk.describe"):
            return orig[1](*a, **k)

    sift.keypoints_and_planes, sift.describe_keypoints = front_end, describe
    try:
        yield
    finally:
        sift.keypoints_and_planes, sift.describe_keypoints = orig


def trace_info(st, trace_cfg):
    """K3's bound summed over the traced chunks, from the reference's
    keypoints on the same images."""
    cfg = reference_sift(st.config)
    bound = 0.0
    for k in st.traced:
        _, work = detect_describe(st.pool[k], cfg, k3_work=True)
        bound += k3_bound_s(work, cfg)[0]
        del work
    return {"steps": len(st.traced), "images": 2 * st.mix["pairs"] * len(st.traced),
            "k3_bound_s": bound}


def release(st):
    """The answers are all the program leaves: nothing to free."""


def reference_outputs(st, k, lower=False):
    """The reference's features (dict of (2P, M) fields) and (P, M) match
    indices for pool chunk ``k``; ``lower``: the control."""
    cfg = reference_sift(st.config)
    f = detect_describe(st.pool[k], cfg, lower=lower)
    p = st.mix["pairs"]
    mode = {"fp32": "tf32", "bf16": "fp8"}[st.mix["precision"]] if lower else st.mix["precision"]
    idx = ref_match.pair_match(f.desc[:p], f.valid[:p], f.desc[p:], f.valid[p:],
                               st.mix["ambiguity"], mode)
    return {name: getattr(f, name) for name in FIELDS}, idx


def numbers(st, feats, idx_list, ref_feats, ref_idx):
    """kp_miss, desc_miss and match_miss of one chunk's answers: its
    features and the indices of each step that ran it."""
    gaps, pairing = compare.feature_gaps(feats, ref_feats)
    p = st.mix["pairs"]
    differ = either = 0
    for idx in idx_list:
        for i in range(p):
            d, e = compare.match_miss(idx[i].to(ref_idx.device), ref_idx[i],
                                      pairing[i], pairing[p + i])
            differ += d
            either += e
    gaps["match_miss"] = differ / max(either, 1)
    return gaps


def _worst(st, answers):
    """Each number's worst over the sampled chunks; ``answers(k)`` gives a
    chunk's (features, list of indices) to hold to the reference.  Also
    the steps of the chunks that read over a limit."""
    worst, failed = {}, 0
    for k in st.sampled:
        feats, idx_list = answers(k)
        got = numbers(st, feats, idx_list, *reference_outputs(st, k))
        worst = {n: max(v, worst.get(n, 0.0)) for n, v in got.items()}
        failed += len(idx_list) * any(got[n] > lim for n, lim in st.mix["limits"].items())
    return worst, failed


def check(st):
    if any(k not in st.feats for k in st.sampled):
        return checks({n: float("inf") for n in st.mix["limits"]}, st.mix), 1
    worst, failed = _worst(st, lambda k: (st.feats[k], st.indices[k]))
    return checks(worst, st.mix), failed


def attempted(st):
    return st.steps


def program_numbers(st):
    return _worst(st, lambda k: (st.feats[k], st.indices[k]))[0]


def control(st):
    """The control's numbers: the reference in the precision below the
    configuration's (pyramid in bfloat16, matching operands one step down),
    in the program's place on the sampled chunks."""
    def lower(k):
        feats, idx = reference_outputs(st, k, lower=True)
        return feats, [idx]
    return _worst(st, lower)[0]
