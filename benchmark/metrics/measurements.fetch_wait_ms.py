"""measurements.fetch_wait_ms: milliseconds per measurement of the self time of the
program's span ``yawt/fetch`` in the traced window: the host waiting for each count's result to reach it: time the host waits for the card; less
the part of it that the program's spans inside it cover."""

from harness import program_spans


def read(run):
    return program_spans.self_ms(run, "fetch")
