"""Device microseconds a forward time step: the traced shots'
``kernels.forward`` spans (CUDA events around the kernels' C entry point),
summed, over their summed steps (program spans)."""

from fwibench import program_trace


def read(run):
    return program_trace.us_per_step("kernels.forward")
