"""Generators, one per kind of traffic (``traffic/<mix>.json`` names its
``kind``).  Each module gives:

    setup(config, mix, seed, device, spans) -> state   inputs from the seed
    warmup(state)                   the cell's shapes once, outside the window
    step(state) -> units            one closed-loop step, its answer on the host
    end_to_end(state, units, elapsed_s, latencies_s) -> {metric: value}
    trace_hooks(state)              (optional) context: spans inside the program's calls
    trace_info(state, trace_cfg) -> dict   what the per-layer readers need
    release(state)                  drop the program's state, keep the answers
    check(state) -> ({name: {"value", "limit"}}, failed)   against the reference
    attempted(state) -> int
"""

from __future__ import annotations

import math


def program_sift(config: dict):
    from niftymatch_torch.config import SiftConfig

    return SiftConfig(**config["sift"])


def reference_sift(config: dict):
    from ..reference.sift.config import SiftConfig

    return SiftConfig(**config["sift"])


UNMEASURABLE = 1e9   # a number that could not be taken (no answer): above any limit


def checks(values: dict, mix: dict) -> dict:
    """``{name: {"value", "limit"}}`` for the mix's limits; a value that is
    not finite reads ``UNMEASURABLE``, so that the line stays JSON."""
    lim = mix["limits"]
    out = {}
    for k in lim:
        v = float(values[k])
        out[k] = {"value": v if math.isfinite(v) else UNMEASURABLE, "limit": float(lim[k])}
    return out
