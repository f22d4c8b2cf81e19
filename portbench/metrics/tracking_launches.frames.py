"""Kernels a frame launched under ``nm.slam.frame`` or any of its stages:
the tracking step's share of ``launches_per_frame``."""

from portbench import program_spans


def read(trace, info):
    n = program_spans.frames(trace, info)
    return None if n is None else program_spans.kernels(trace, "nm.slam.frame") / n
