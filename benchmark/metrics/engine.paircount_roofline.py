"""engine.paircount_roofline: the least time the measurement's pair counts
could take on the card (``harness.roofline``: operations for the pairs in
reach that the reference counted, bytes of every point and count), over the
device time of the kernels launched by the count calls (engine.kernel_ms)."""

from harness import roofline


def read(run):
    trace = run.trace
    if trace is None or not run.works or not trace.num_spans.get("measurement"):
        return None
    kernel_s = trace.span_kernel_s.get("count", 0.0) / trace.num_spans["measurement"]
    if kernel_s <= 0:
        return None
    return 100.0 * roofline.least_seconds(run.works) / kernel_s
