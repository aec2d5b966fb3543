"""The program's own spans and counters in a traced run, read for the
per-layer metrics of its stages.

While a profiler records, the port marks its stages as ``yawt/<name>``
ranges in the trace (``yet_another_wizz_tpu_torch/utils/tracing.py``), and
it counts its work and its cache hits and misses in one registry. The
runner hands the readers a summary of the benchmark's own ``bench/`` spans
only (:mod:`harness.trace`), so this module reads the run's exported trace
itself: ``trace.json.gz`` in the output directory of the run whose
:func:`harness.runner.run` calls the reader (its ``out_dir``, found on the
call stack beside the readers' ``RunData``). The counters of the traced
window are what the program counted while the profiler recorded
(``tracing.recorded()``). A program without spans or counters finds
nothing here, and the readers return None.

A span's self time is its duration less the part of it that its ``yawt/``
child spans cover, on its own thread (spans nest by containment there).
"""

from __future__ import annotations

import sys
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from harness import trace as bench_trace

PREFIX = "yawt/"
ROOTS = ("crosscorrelate", "autocorrelate", "crosscorrelate_scalar",
         "autocorrelate_scalar")
"""The program's root spans, one per measurement call: no stage's time."""
COUNT_SPAN = "bench/count"
SLACK_S = 2e-9
"""Rounding of the trace's microsecond timestamps: a child may end this much
after its parent."""


@dataclass
class ProgramSpans:
    """The ``yawt/`` spans of a trace, by name without the prefix; times in
    seconds over the whole trace."""

    num: dict = field(default_factory=dict)
    total_s: dict = field(default_factory=dict)
    self_s: dict = field(default_factory=dict)
    count_s: float = 0.0  # time in the benchmark's spans around the calls
    count_covered_s: float = 0.0  # the part of it the stage spans cover

    @property
    def count_coverage(self) -> float | None:
        """The share of ``bench/count`` time that the stage spans (every
        ``yawt/`` span but the roots) cover."""
        return self.count_covered_s / self.count_s if self.count_s > 0 else None


def summarize(events: list) -> ProgramSpans:
    """Counts, total and self seconds of the ``yawt/`` ranges of a Chrome
    trace's events, and their cover of the ``bench/count`` ranges."""
    by_thread = defaultdict(list)
    counts = defaultdict(list)
    for event in events:
        if event.get("ph") != "X":
            continue
        if str(event.get("cat", "")).lower() != "user_annotation":
            continue
        name = str(event.get("name", ""))
        start = float(event["ts"]) * 1e-6
        end = start + float(event.get("dur", 0.0)) * 1e-6
        thread = (event.get("pid"), event.get("tid"))
        if name.startswith(PREFIX):
            by_thread[thread].append([start, end, name[len(PREFIX):], 0.0])
        elif name == COUNT_SPAN:
            counts[thread].append((start, end))

    spans = ProgramSpans()
    for thread, ranges in by_thread.items():
        ranges.sort(key=lambda r: (r[0], -r[1]))
        stack: list = []
        for item in ranges:
            start, end = item[0], item[1]
            while stack and not (start >= stack[-1][0] and end <= stack[-1][1] + SLACK_S):
                stack.pop()
            if stack:
                parent = stack[-1]
                parent[3] += min(end, parent[1]) - max(start, parent[0])
            stack.append(item)
        for start, end, name, children in ranges:
            spans.num[name] = spans.num.get(name, 0) + 1
            spans.total_s[name] = spans.total_s.get(name, 0.0) + (end - start)
            spans.self_s[name] = spans.self_s.get(name, 0.0) + max(
                0.0, (end - start) - children)
        stages = bench_trace.merge(
            [(s, e) for s, e, name, _ in ranges if name not in ROOTS])
        starts = np.array([s for s, _ in stages])
        for start, end in counts.get(thread, []):
            spans.count_covered_s += bench_trace.covered(stages, starts, start, end)
    spans.count_s = sum(e - s for ranges in counts.values() for s, e in ranges)
    return spans


_cache: dict = {}


def _out_dir(run) -> Path | None:
    """The output directory of the run that calls the reader: ``out_dir``
    in the frame of :func:`harness.runner.run` that holds ``run``."""
    frame = sys._getframe(1)
    while frame is not None:
        local = frame.f_locals
        if local.get("run_data") is run and "out_dir" in local:
            return Path(local["out_dir"])
        frame = frame.f_back
    return None


def of_run(run) -> ProgramSpans | None:
    """The program's spans in the traced run ``run`` (None without a
    trace, or where the program has no spans)."""
    if run.trace is None:
        return None
    out_dir = _out_dir(run)
    path = None if out_dir is None else out_dir / "trace.json.gz"
    if path is None or not path.is_file():
        return None
    key = (str(path), path.stat().st_mtime_ns)
    if key not in _cache:
        _cache.clear()
        _cache[key] = summarize(bench_trace.load_events(str(path)))
    spans = _cache[key]
    return spans if spans.num else None


def measurements(run) -> int:
    """The measurements of the traced window (its ``bench/measurement``
    spans)."""
    return int(run.trace.num_spans.get("measurement", 0)) if run.trace else 0


def self_ms(run, name: str) -> float | None:
    """Milliseconds per measurement of the self time of the span ``name``,
    or None where the run has no such span."""
    spans = of_run(run)
    if spans is None or name not in spans.self_s or not measurements(run):
        return None
    return 1e3 * spans.self_s[name] / measurements(run)


def window_counters(run) -> dict | None:
    """What the program counted in the traced window, or None where it has
    no counters or the run was not traced."""
    if run.trace is None or not measurements(run):
        return None
    try:
        from yet_another_wizz_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.recorded()
