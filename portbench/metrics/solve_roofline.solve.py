"""The solves' share of their roofline, in %: the least time of the solves
the program's ``ba_cg.*`` counters record (``counts.ba.bound_from_counters``:
the larger of their bytes and their float32 operations at the card's
peaks) over the device time of the kernels under the program's ``nm.ba.``
regions.  A program without the regions or the counters leaves nothing to
read."""

from portbench.counts.ba import bound_from_counters


def read(trace, info):
    if not any(n.startswith("nm.ba.") for n, _, _ in trace.spans):
        return None
    try:
        from niftymatch_torch.utils.profiling import counts
    except ImportError:
        return None
    least = bound_from_counters(counts())
    spent = trace.device_s("nm.ba.")
    return 100.0 * least / spent if least and spent > 0 else None
