"""Kernels a frame in the traced SLAM chunk: every kernel event on the
device over the frames the chunk processed."""


def read(trace, info):
    if not info.get("frames"):
        return None
    return len(trace.kernels()) / info["frames"]
