"""device.idle_pct: the share of the traced window in which no kernel, copy
or set ran on the card (the profiler's device timeline)."""


def read(run):
    trace = run.trace
    if trace is None or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
