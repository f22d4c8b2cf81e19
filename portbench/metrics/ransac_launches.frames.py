"""Kernels a frame launched under ``nm.slam.frame.ransac_e`` and
``nm.slam.frame.ransac_h``: the two RANSACs of each frame."""

from portbench import program_spans


def read(trace, info):
    n = program_spans.frames(trace, info)
    return None if n is None else program_spans.kernels(trace, "nm.slam.frame.ransac_") / n
