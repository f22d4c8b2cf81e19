"""Kernels a solve launched under the program's ``nm.ba.`` regions (the
whole of ``bundle_adjust_cg``), over the traced solves.  A program that
opens no such region leaves nothing to read."""


def read(trace, info):
    if not info.get("steps") or not any(n.startswith("nm.ba.") for n, _, _ in trace.spans):
        return None
    return len(trace.kernels("nm.ba.")) / info["steps"]
