"""Device ms a solve in the linearisations (``nm.ba.linearize``: Jacobians,
block sums, H_ll^-1, the right-hand side and the preconditioner), over the
traced solves.  A program that opens no ``nm.ba.`` region leaves nothing
to read."""


def read(trace, info):
    if not info.get("steps") or not any(n.startswith("nm.ba.") for n, _, _ in trace.spans):
        return None
    return 1e3 * trace.device_s("nm.ba.linearize") / info["steps"]
