"""Process start to the window's start: imports, the kernels' libraries,
the models, the observed data and the warm shots."""


def read(run):
    return run.setup_s
