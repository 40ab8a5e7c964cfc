"""Host waits on the device a shot: the program's ``host_syncs`` counter's
change over the traced ``objective.evaluation`` spans over their shots
(program counter)."""

from fwibench import program_trace


def read(run):
    spans = program_trace.records()
    if spans is None:
        return None
    evals = program_trace.named(spans, "objective.evaluation")
    shots = sum(e.attrs["shots"] for e in evals)
    if not shots:
        return None
    return sum(e.delta("host_syncs") for e in evals) / shots
