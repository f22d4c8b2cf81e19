"""K3's share of its roofline, in %: its least time on the traced chunks
(``counts.k3_bound_s`` on the reference's keypoints of the same images)
over its summed device time, found by kernel name."""

KERNEL = "descriptor_kernel"


def read(trace, info):
    spent = trace.device_s(name_has=KERNEL)
    if spent <= 0 or not info.get("k3_bound_s"):
        return None
    return 100.0 * info["k3_bound_s"] / spent
