"""The traced shots' least time on the card (fwibench/counts.py: each
pass at the larger of its operations over 67 TFLOP/s and its bytes over
3.35 TB/s) over the union of kernel busy time: the whole shot's share of
its roofline."""


def read(run):
    t = run.trace
    if t is None or t.kernels == 0 or t.busy_s <= 0:
        return None
    return 100.0 * run.traced_shots * run.shot_bound_s / t.busy_s
