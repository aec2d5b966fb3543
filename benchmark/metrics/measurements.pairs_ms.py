"""measurements.pairs_ms: milliseconds per measurement of the self time of the
program's span ``yawt/pairs`` in the traced window: the tile-pair list of each count (``build_tile_pairs``: its memo, or the build); less
the part of it that the program's spans inside it cover."""

from harness import program_spans


def read(run):
    return program_spans.self_ms(run, "pairs")
