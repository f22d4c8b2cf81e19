"""The device's idle share of the traced window, in %: 1 minus the union
of its kernel, copy and set intervals over the window's wall length."""


def read(trace, info):
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_ns / 1e9 / trace.window_s)
