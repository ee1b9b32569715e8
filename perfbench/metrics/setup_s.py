"""setup_s: process start to the first timed batch (data, index build,
the warm batch and, on a checkout's first run, the kernels' build)."""


def read(run):
    return run.setup_s
