"""Device ms a sweep outside K1: the kernels launched inside the harness's
span around ``allpairs_match_fused`` that are not K1 (preparation,
acceptance, the mutual gather), over the traced sweeps."""

K1 = "match_top2_kernel"


def read(trace, info):
    if not info.get("steps"):
        return None
    inside = trace.device_s("sweep.allpairs")
    return 1e3 * (inside - trace.device_s("sweep.allpairs", K1)) / info["steps"]
