"""measurements.finalize_ms: milliseconds per measurement of the self time of the
program's span ``yawt/finalize`` in the traced window: turning each count's result into per-scale patch-pair counts on the host (``counts_to_scales``, the scatter, the sums of weights); less
the part of it that the program's spans inside it cover."""

from harness import program_spans


def read(run):
    return program_spans.self_ms(run, "finalize")
