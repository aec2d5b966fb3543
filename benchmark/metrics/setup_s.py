"""setup_s: seconds from the start of the process to the start of the
window: inputs, the system's set-up, the kernels' build and the warm-up
measurement (host clock)."""


def read(run):
    return run.setup_s
