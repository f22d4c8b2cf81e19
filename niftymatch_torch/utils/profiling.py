"""Profiling and tracing, the counterpart of ``utils/profiling.py`` of the
JAX package:

* :func:`trace`: ``torch.profiler`` around a block, written as a Chrome
  trace (``trace.json`` in the directory given; Perfetto reads it) with the
  block's counters beside it (``counters.json``);
* :func:`annotate`: a named region in that trace
  (``torch.profiler.record_function``), opened only while a profiler
  records;
* :func:`count` / :func:`counts`: named counters of host-side facts (never
  a device value), kept only while a profiler records;
* :func:`roofline`: the measured time of a matmul-shaped call against the
  card's peak tensor-core rate and memory rate.

Tracing is on exactly when a ``torch.profiler`` records, whoever started
it: no setting turns it on.  Off, :func:`annotate` and :func:`count` cost
one flag check each.  The program's regions are named
``nm.<layer>.<stage>[.<sub-stage>]``, dotted by parent, so a prefix selects
a stage and all of its children; its counters ``<layer>.<quantity>``.

The peaks are keyed by the card's name (``torch.cuda.get_device_name``);
an unknown card raises rather than borrow another device's numbers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

# The profiler's host and device clocks part by up to 31.6 ms on the H100
# (PERF.md), and it keeps only the device activity whose time, read on the
# host's clock, falls inside the session.  A session around one short call
# can therefore come back with no kernel at all; one that waits this long on
# the host before and after the call keeps them.
CLOCK_PAD_S = 0.1

# NVIDIA's H100 SXM data sheet, dense rates at the 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_gbps": 3.35e12},
}


_OFF = contextlib.nullcontext()
_COUNTS: dict = {}


def _recording() -> bool:
    return _autograd_profiler._is_profiler_enabled


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace(dir): run()`` writes ``dir/trace.json`` (host and, on a
    card, device activity) and ``dir/counters.json`` (:func:`counts` of the
    block)."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    _COUNTS.clear()
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "counters.json"), "w") as f:
        json.dump(counts(), f, indent=1, sort_keys=True)


def annotate(name: str):
    """A named region of the trace while a profiler records; otherwise one
    shared null context."""
    return record_function(name) if _recording() else _OFF


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records."""
    if _recording():
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def counts() -> dict:
    """A copy of the counters (reset by :func:`trace` on entry)."""
    return dict(_COUNTS)


@dataclasses.dataclass
class RooflineReport:
    wall_s: float
    flops: float
    bytes_accessed: float
    achieved_tflops: float
    mxu_utilization: float      # share of the peak tensor-core bf16 rate (the name is the JAX package's)
    achieved_gbps: float        # bytes/s
    hbm_utilization: float
    compute_bound: bool         # arithmetic intensity above the ridge

    def __str__(self):
        side = "compute" if self.compute_bound else "memory"
        return (f"{self.achieved_tflops:.1f} TFLOP/s ({self.mxu_utilization:.1%} of the "
                f"tensor cores' bf16 peak), {self.achieved_gbps / 1e9:.0f} GB/s "
                f"({self.hbm_utilization:.1%} of HBM), {side}-bound")


def peaks_of(device_kind: str) -> dict:
    """The peak rates of a card by name; raises for a card not in PEAKS."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(f"no peak rates known for {device_kind!r}; pass peaks=") from None


def roofline(fn, args_sets, flops: float, bytes_accessed: float, iters: int = 20,
             device_kind: str | None = None, peaks: dict | None = None) -> RooflineReport:
    """Time ``fn`` over distinct argument sets (``timing.benchmark``) and
    report its rates against the peaks: ``peaks`` if given ({"bf16_flops",
    "hbm_gbps"}, both per second), else those of ``device_kind`` (the
    current card's name by default).  ``flops``/``bytes_accessed`` are the
    caller's counts per call (e.g. 2*M*N*D for a distance GEMM)."""
    from .timing import benchmark

    if peaks is None:
        peaks = peaks_of(device_kind or torch.cuda.get_device_name(0))
    wall = benchmark(fn, args_sets, iters=iters) / 1e3
    achieved_flops = flops / wall
    achieved_bw = bytes_accessed / wall
    ridge = peaks["bf16_flops"] / peaks["hbm_gbps"]
    return RooflineReport(
        wall_s=wall, flops=flops, bytes_accessed=bytes_accessed,
        achieved_tflops=achieved_flops / 1e12,
        mxu_utilization=achieved_flops / peaks["bf16_flops"],
        achieved_gbps=achieved_bw, hbm_utilization=achieved_bw / peaks["hbm_gbps"],
        compute_bound=flops / max(bytes_accessed, 1.0) > ridge)
