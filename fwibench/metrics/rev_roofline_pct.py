"""The traced shots' 2D acoustic reverse as a share of its roofline: the
least time of each ``kernels.reverse`` span (``counts_streamed``'s reverse
pass at the span's padded grid, radius, strip depth, sources, receivers
and tape mode, times its nt), summed, over the spans' summed device time
(program spans). None where a span lacks those attributes (a program from
before them, or another engine's reverse) or where there is no reverse."""

from fwibench import counts, counts_streamed, program_trace

TAPES = {"snap": ("snapshot", "bfloat16"), "rings": ("rings", "float32")}
ATTRS = ("nt", "NZ", "NX", "radius", "strip", "nsrc", "nrec", "tape")


def bound_s(a: dict) -> float:
    """Least seconds of the reverse call whose span attributes are ``a``."""
    shape = (a["NZ"] - 2 * a["strip"], a["NX"] - 2 * a["strip"])
    c = counts_streamed.passes(shape, 2 * a["radius"], a["strip"] - a["radius"], a["nt"],
                               a["nsrc"], a["nrec"], TAPES[a["tape"]], True)["reverse"]
    return a["nt"] * counts.step_bound_s(c, a["nt"])[0]


def read(run):
    spans = program_trace.records()
    if spans is None:
        return None
    ks = program_trace.in_shots(spans, ("kernels.reverse",))
    if any(not set(ATTRS) <= set(k.attrs) for k in ks):
        return None
    t = program_trace.device_times(ks)
    if t is None:
        return None
    return 100.0 * sum(bound_s(k.attrs) for k in ks) / sum(t)
