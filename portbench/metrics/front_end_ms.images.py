"""Device ms a chunk of the front end (``sift.keypoints_and_planes``:
pyramid, detection, merge, gradient planes): the kernels launched inside
the harness's span around that call, over the traced chunks."""


def read(trace, info):
    if not info.get("steps"):
        return None
    return 1e3 * trace.device_s("chunk.front_end") / info["steps"]
