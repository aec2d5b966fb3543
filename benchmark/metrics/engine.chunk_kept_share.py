"""engine.chunk_kept_share: of the 32 x 32 chunk blocks that the launches of
the cumulative pair-count kernel (K1.1, K1.2) decided on in the traced window
(the program's counter ``engine.chunk_blocks``), the share its chunk skip
kept and evaluated (``engine.chunk_blocks_kept``, counted on the card), in
percent. None where the program has no such counters."""

from harness import program_spans


def read(run):
    counted = program_spans.window_counters(run)
    if not counted or not counted.get("engine.chunk_blocks"):
        return None
    kept = counted.get("engine.chunk_blocks_kept")
    if kept is None:
        return None
    return 100.0 * kept / counted["engine.chunk_blocks"]
