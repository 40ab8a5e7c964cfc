"""Device milliseconds a shot in the elastic propagator's work outside the
engine's kernels: the mean over the traced shots of the device time of
their ``propagator.materials`` spans (the map from (vp, vs, rho) to the
padded staggered materials) and ``engine.finish`` spans (the force's buoy_z
term, the wavelet's cotangent and the valid-region mask of the reverse's
cotangents), summed (program spans). None where the program records
neither, as before it had them."""

from fwibench import program_trace

NAMES = ("propagator.materials", "engine.finish")


def read(run):
    spans = program_trace.records()
    if spans is None:
        return None
    shots = program_trace.named(spans, "objective.shot")
    t = program_trace.device_times(program_trace.in_shots(spans, NAMES))
    if not shots or t is None:
        return None
    return 1e3 * sum(t) / len(shots)
