"""Process start to the first timed call: imports, the card's context,
loading (or building) the kernels, the pipeline's plans, the scene and the
warm-up."""


def read(run):
    return run.setup_s
