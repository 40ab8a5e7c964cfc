"""100 - (union of all kernel intervals) / (the traced window's host time)."""


def read(run):
    t = run.trace
    if t is None or t.kernels == 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
