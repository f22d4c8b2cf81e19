"""Host ms a frame waiting on the device in the SLAM loop's fetches: the
chunk's one ``host_fetch`` (``nm.slam.fetch``) and the window BA's landmark
fetch (``nm.slam.ba_fetch``)."""

from portbench import program_spans


def read(trace, info):
    n = program_spans.frames(trace, info)
    if n is None:
        return None
    return 1e3 * program_spans.host_s(trace, ["nm.slam.fetch", "nm.slam.ba_fetch"]) / n
