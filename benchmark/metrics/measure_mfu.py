"""measure_mfu: the least time of the measurement's pair counts (as for
engine.paircount_roofline) over the whole measurement's time in the traced
window: the share of the card's peak that a measurement reaches end to end."""

from harness import roofline


def read(run):
    trace = run.trace
    if trace is None or not run.works or not trace.num_spans.get("measurement"):
        return None
    measure_s = trace.span_s["measurement"] / trace.num_spans["measurement"]
    return 100.0 * roofline.least_seconds(run.works) / measure_s
