"""Host ms a frame inside the SLAM loop's ``nm.slam.frame`` spans: the time
the host takes to enqueue one frame's tracking (match, both RANSACs, model
selection, scale and triangulation, the carry update)."""

from portbench import program_spans


def read(trace, info):
    n = program_spans.frames(trace, info)
    return None if n is None else 1e3 * program_spans.host_s(trace, ["nm.slam.frame"]) / n
