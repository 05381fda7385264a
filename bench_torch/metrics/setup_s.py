"""Process start to the first timed render: imports, the kernels' build or
load, the scene, the warm-up renders."""


def read(run):
    return run.setup_s
