"""The traced slice of a run: the harness's spans and the device's events.

Spans are ``torch.profiler.record_function`` ranges that the harness opens
around its calls into the program's layers, so they share the profiler's
clock with the device events.  Everything is counted from the raw kineto
events (``kineto_results.events()``), as ``niftymatch_torch/utils/
smoke_sfm.profile`` counts them: building the profiler's event tree takes
minutes at the ~200,000 kernels of a SLAM chunk.

A device event is attributed to the span its launch was made in, by the
correlation id that links it to the host's runtime call.  The busy time is
the union of the device's kernel, copy and set intervals; an idle gap is a
stretch of the traced window in which none runs, labelled by the innermost
span the host was in when it began.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import NamedTuple

import torch

WINDOW = "portbench.window"   # the span around the whole traced slice
NAME_CHARS = 120              # a kernel's name in the breakdown, cut to this


class DeviceOp(NamedTuple):
    name: str
    start_ns: int
    dur_ns: int
    span: str          # innermost harness span of its launch, "" if none
    kernel: bool       # False for copies and sets


class Trace(NamedTuple):
    ops: list          # [DeviceOp]
    spans: list        # [(name, start_ns, end_ns)]
    window_ns: tuple   # (start, end) of the traced slice
    busy_ns: int
    gaps: list         # [(label, ns)]

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def kernels(self, span_prefix: str | None = None):
        return [o for o in self.ops if o.kernel
                and (span_prefix is None or o.span.startswith(span_prefix))]

    def device_s(self, span_prefix: str | None = None, name_has: str | None = None) -> float:
        return sum(o.dur_ns for o in self.kernels(span_prefix)
                   if name_has is None or name_has in o.name) / 1e9


class Spans:
    """The harness's spans: ``with spans("pairs.detect"):`` opens a
    ``record_function`` range while a profile is on, and nothing otherwise."""

    def __init__(self):
        self.on = False

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)


def _union(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def read(prof) -> Trace:
    """The ``Trace`` of a finished ``torch.profiler.profile``."""
    raw = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    spans, launch_at, device = [], {}, []
    for e in raw:
        if e.is_user_annotation():
            # A range opened by record_function is also drawn on the
            # device's timeline; only its host range is a span.
            if e.device_type() != cuda:
                spans.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        elif e.device_type() == cuda:
            device.append(e)
        else:
            name = e.name()
            if name.startswith(("cuda", "cu")) and e.correlation_id():
                launch_at[e.correlation_id()] = e.start_ns()
    win = [s for s in spans if s[0] == WINDOW]
    if not win:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = win[0][1], win[0][2]
    inner = sorted((s for s in spans if s[0] != WINDOW), key=lambda s: s[1])
    starts = [s[1] for s in inner]

    def span_at(t):
        i = bisect.bisect_right(starts, t) - 1
        best = ""
        # Innermost: the latest-starting span that still covers t.
        while i >= 0:
            name, s, e = inner[i]
            if e >= t:
                best = name
                break
            i -= 1
        return best

    ops = []
    span_names = {s[0] for s in spans}
    for e in device:
        name = e.name()
        if name in span_names:
            continue
        kernel = not name.startswith(("Memcpy", "Memset"))
        t_launch = launch_at.get(e.correlation_id())
        ops.append(DeviceOp(name, e.start_ns(), e.duration_ns(),
                            span_at(t_launch) if t_launch is not None else "", kernel))
    ops = [o for o in ops if o.start_ns < w1 and o.start_ns + o.dur_ns > w0]
    clipped = sorted((max(o.start_ns, w0), min(o.start_ns + o.dur_ns, w1)) for o in ops)
    busy = _union(clipped)
    gaps = defaultdict(int)
    cursor = w0
    for s, e in clipped + [(w1, w1)]:
        if s > cursor:
            gaps[span_at(cursor) or "outside any span"] += s - cursor
        cursor = max(cursor, e)
    return Trace(ops, inner, (w0, w1), busy, sorted(gaps.items(), key=lambda g: -g[1]))


def breakdown(trace: Trace, top: int = 10) -> dict:
    by_name = defaultdict(int)
    for o in trace.ops:
        by_name[o.name] += o.dur_ns
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:NAME_CHARS], ns / 1e9] for n, ns in device_ops],
            "idle_gaps": [[n, ns / 1e9] for n, ns in trace.gaps[:top]]}
