"""measurements.tiles_ms: milliseconds per measurement of the self time of the
program's span ``yawt/tiles`` in the traced window: the tile lookup of each count (the two ``Catalog.get_tiles``); less
the part of it that the program's spans inside it cover."""

from harness import program_spans


def read(run):
    return program_spans.self_ms(run, "tiles")
