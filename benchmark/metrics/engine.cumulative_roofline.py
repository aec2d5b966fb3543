"""engine.cumulative_roofline: the least time of the measurement's pair
counts on the card (``harness.roofline``, from the pairs in reach that the
reference counted), over the device time per measurement of the cumulative
pair-count kernel's instances (K1.1, K1.2): the kernels of the traced
window whose names hold ``paircount_partials_kernel`` (among the trace's
longest device operations, ``breakdown.device_ops``). A cell whose counts
are all cumulative reads the share of their roofline that those kernels
reach. None where no such kernel ran."""

from harness import roofline

KERNEL = "paircount_partials_kernel"


def read(run):
    trace = run.trace
    if trace is None or not run.works or not trace.num_spans.get("measurement"):
        return None
    seconds = sum(s for name, s in trace.device_ops if KERNEL in name)
    if seconds <= 0:
        return None
    per_measurement = seconds / trace.num_spans["measurement"]
    return 100.0 * roofline.least_seconds(run.works) / per_measurement
