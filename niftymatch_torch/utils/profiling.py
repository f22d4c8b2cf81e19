"""Profiling and tracing, the counterpart of ``utils/profiling.py`` of the
JAX package:

* :func:`trace`: ``torch.profiler`` around a block, written as a Chrome
  trace (``trace.json`` in the directory given; Perfetto reads it);
* :func:`annotate`: a named region in that trace
  (``torch.profiler.record_function``);
* :func:`roofline`: the measured time of a matmul-shaped call against the
  card's peak tensor-core rate and memory rate.

The peaks are keyed by the card's name (``torch.cuda.get_device_name``);
an unknown card raises rather than borrow another device's numbers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# NVIDIA's H100 SXM data sheet, dense rates at the 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_gbps": 3.35e12},
}


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace(dir): run()`` writes ``dir/trace.json`` (host and, on a
    card, device activity)."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """A named region of the trace."""
    return record_function(name)


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
