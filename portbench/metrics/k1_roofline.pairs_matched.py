"""K1's share of its roofline, in %: the sweep's least time
(``counts.sweep_bound_s``: 2 (K N)^2 D operations at the mode's tensor-core
rate, three TF32 products in fp32 mode) over K1's summed device time on the
traced sweeps, found by kernel name."""

K1 = "match_top2_kernel"


def read(trace, info):
    spent = trace.device_s(name_has=K1)
    if spent <= 0 or not info.get("k1_bound_s"):
        return None
    return 100.0 * info["k1_bound_s"] / spent
