"""Device ms a chunk of the describe stage (``sift.describe_keypoints``:
K2, the peaks, K3, normalisation, top-k), inside the harness's span around
that call, over the traced chunks."""


def read(trace, info):
    if not info.get("steps"):
        return None
    return 1e3 * trace.device_s("chunk.describe") / info["steps"]
