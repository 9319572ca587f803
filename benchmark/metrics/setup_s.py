"""Process start to the window's first request: imports, kernel libraries,
weights, inputs and the warm-up."""


def read(run):
    return run.setup_s
