"""The window's peak device memory beyond one shot's tape, in GiB:
``peak_bytes`` less the largest tape one ``kernels.forward`` span
allocated (its ``tape_bytes``; program spans)."""

from fwibench import program_trace


def read(run):
    spans = program_trace.records()
    if spans is None or run.peak_bytes is None:
        return None
    tape = max((k.attrs["tape_bytes"] for k in program_trace.named(spans, "kernels.forward")),
               default=0)
    if not tape:
        return None
    return (run.peak_bytes - tape) / 2**30
