"""measurements.host_ms: milliseconds per measurement inside the
benchmark's spans around the crosscorrelate / autocorrelate calls in which
no kernel, copy or set ran on the card: host work the device waits on."""


def read(run):
    trace = run.trace
    if trace is None or "count" not in trace.span_host_s:
        return None
    return 1e3 * trace.span_host_s["count"] / trace.num_spans["measurement"]
