"""Device kernels in the traced window over (shots x nt)."""


def read(run):
    t = run.trace
    if t is None or t.kernels == 0:
        return None
    return t.kernels / (run.traced_shots * run.nt)
