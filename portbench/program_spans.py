"""The program's own spans in a traced slice: the ``utils.profiling``
regions (``nm.<layer>.<stage>...``) that ``niftymatch_torch`` opens while a
profiler records.  They sit in ``Trace.spans`` beside the harness's, on the
same clock, and a device op launched inside one carries its name as its
innermost span.  A program without them (an older checkout) leaves every
reader of this module with nothing to read: ``None``, never an error."""

from __future__ import annotations

PREFIX = "nm."


def traced(trace) -> bool:
    """Whether the slice holds any of the program's spans."""
    return any(name.startswith(PREFIX) for name, _, _ in trace.spans)


def frames(trace, info):
    """The traced frames, the per-frame metrics' denominator, or None."""
    return (info.get("frames") or None) if traced(trace) else None


def host_s(trace, names) -> float:
    """Host seconds inside the spans named ``names`` (a name ending in
    ``.`` selects every span under it)."""
    return sum(e - s for name, s, e in trace.spans
               if any(name == n or (n.endswith(".") and name.startswith(n))
                      for n in names)) / 1e9


def kernels(trace, prefix: str) -> int:
    """Kernels whose launch's innermost span starts with ``prefix``."""
    return len(trace.kernels(prefix))
