"""Device ms a frame in the traced SLAM chunk: summed kernel durations
over the frames the chunk processed."""


def read(trace, info):
    if not info.get("frames"):
        return None
    return 1e3 * trace.device_s() / info["frames"]
