"""measurements.linkage_ms: milliseconds per measurement of the self time of the
program's span ``yawt/linkage`` in the traced window: the patch linkage and angular edge tables that each call builds (``PatchLinkage.from_catalogs``); less
the part of it that the program's spans inside it cover."""

from harness import program_spans


def read(run):
    return program_spans.self_ms(run, "linkage")
