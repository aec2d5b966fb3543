"""measure_s: the window's length over the measurements completed in it,
each the traffic's whole call sequence to n(z), synchronised (host clock)."""


def read(run):
    if not run.num_measurements:
        return None
    return run.window_s / run.num_measurements
