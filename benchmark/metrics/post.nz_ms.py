"""post.nz_ms: milliseconds per measurement of the benchmark's span around
RedshiftData.from_corrfuncs, synchronised."""


def read(run):
    trace = run.trace
    if trace is None or not trace.num_spans.get("nz"):
        return None
    return 1e3 * trace.span_s["nz"] / trace.num_spans["measurement"]
