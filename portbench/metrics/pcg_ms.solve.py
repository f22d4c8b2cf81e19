"""Device ms a solve in the CG loops (``nm.ba.pcg``): the kernels launched
inside the program's region, over the traced solves.  A program that
opens no ``nm.ba.`` region leaves nothing to read."""


def read(trace, info):
    if not info.get("steps") or not any(n.startswith("nm.ba.") for n, _, _ in trace.spans):
        return None
    return 1e3 * trace.device_s("nm.ba.pcg") / info["steps"]
