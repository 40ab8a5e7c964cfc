"""Device milliseconds a shot outside its kernels: the mean over the
traced shots of an ``objective.shot`` span's device time less that of the
``kernels.*`` spans inside it. What remains is the low-pass, the misfit,
the gradient sum, the engines' per-call set-up and the idle the host
leaves between them (program spans)."""

from fwibench import program_trace


def read(run):
    spans = program_trace.records()
    if spans is None:
        return None
    shots = program_trace.named(spans, "objective.shot")
    t = program_trace.device_times(shots)
    if t is None:
        return None
    rest = []
    for shot, ts in zip(shots, t):
        k = program_trace.device_times(program_trace.below(spans, shot, program_trace.KERNELS))
        if k is None:
            return None
        rest.append(ts - sum(k))
    return 1e3 * sum(rest) / len(rest)
