"""Device microseconds a reverse step of the elastic reverse's free-surface
image launches: the traced evaluation's device time of the kernels whose
names hold ``er_image`` (the trace's ``device_ops``), over the change of
the program's ``escan_image_steps`` counter over the traced
``objective.evaluation`` spans (program counter and device trace).

The reverse launches each step as a programmatic dependent of the one
before it, and under dependent launch a kernel's profiler span includes
its wait for that kernel (PERF.md section 5): the reading is an upper
bound of the images' cost. None where the program keeps no such counter,
where no reverse with the free surface ran, or where the trace names no
image kernel.
"""

from fwibench import program_trace

COUNTER = "escan_image_steps"


def read(run):
    t = run.trace
    spans = program_trace.records()
    if t is None or spans is None:
        return None
    evals = program_trace.named(spans, "objective.evaluation")
    if not evals or any(COUNTER not in e.counters0 for e in evals):
        return None
    steps = sum(e.delta(COUNTER) for e in evals)
    seconds = sum(s for name, s in t.device_ops if "er_image" in name)
    if steps <= 0 or seconds <= 0:
        return None
    return 1e6 * seconds / steps
