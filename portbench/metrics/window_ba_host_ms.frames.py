"""Host ms a frame inside ``nm.slam.window_ba.*``: packing the window's
problem on the host (``pack``) and enqueueing its solve (``solve``)."""

from portbench import program_spans


def read(trace, info):
    n = program_spans.frames(trace, info)
    return None if n is None else 1e3 * program_spans.host_s(trace, ["nm.slam.window_ba."]) / n
