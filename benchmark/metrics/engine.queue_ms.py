"""engine.queue_ms: milliseconds per measurement of the self time of the
program's span ``yawt/engine.queue`` in the traced window: queueing each count on the card: the threshold table, lanes and pair index (cached uploads), the kernel launches and the queued copy of the result; less
the part of it that the program's spans inside it cover."""

from harness import program_spans


def read(run):
    return program_spans.self_ms(run, "engine.queue")
