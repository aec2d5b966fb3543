"""engine.kernel_ms: device milliseconds per measurement of every kernel
launched inside the benchmark's spans around the count calls (no filter on
kernel names)."""


def read(run):
    trace = run.trace
    if trace is None or not trace.num_spans.get("measurement"):
        return None
    seconds = trace.span_kernel_s.get("count", 0.0)
    if seconds <= 0:
        return None
    return 1e3 * seconds / trace.num_spans["measurement"]
