"""measurements.cache_misses: the misses of the program's caches that a
repeated measurement reuses (its counters ``cache.miss.<kind>``: tiles,
pair lists, pair indices, threshold tables, lanes, packed-tile stores),
summed over the traced window, per measurement. A warm measurement reads 0."""

from harness import program_spans


def read(run):
    counted = program_spans.window_counters(run)
    if counted is None or not any(name.startswith("cache.") for name in counted):
        return None
    misses = sum(value for name, value in counted.items()
                 if name.startswith("cache.miss."))
    return misses / program_spans.measurements(run)
