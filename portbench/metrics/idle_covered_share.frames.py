"""Share of the traced window's idle, in %, in gaps that began while the
host was inside one of the program's spans: how much of the device's idle
the program's stages account for."""

from portbench import program_spans


def read(trace, info):
    idle = sum(ns for _, ns in trace.gaps)
    if not program_spans.traced(trace) or idle <= 0:
        return None
    return 100.0 * sum(ns for label, ns in trace.gaps
                       if label.startswith(program_spans.PREFIX)) / idle
