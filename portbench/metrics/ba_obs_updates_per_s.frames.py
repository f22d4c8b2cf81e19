"""Window-BA observation updates a second of device time: the program's
counter ``ba.obs_updates`` (each solve's real observations times its LM
iterations) over the device seconds of the kernels launched under
``nm.slam.window_ba.solve``."""

from portbench import program_spans


def read(trace, info):
    if not program_spans.traced(trace):
        return None
    try:
        from niftymatch_torch.utils.profiling import counts
    except ImportError:
        return None
    updates = counts().get("ba.obs_updates", 0)
    spent = trace.device_s("nm.slam.window_ba.solve")
    return updates / spent if updates and spent > 0 else None
