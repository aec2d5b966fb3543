"""The profiler's trace of the measured window, read for the per-layer
metrics and the breakdown.

The window is traced with ``torch.profiler`` (CPU and CUDA activities); the
benchmark's spans appear in it as ``bench/<name>`` ranges. Device time is
the union of kernel, copy and set intervals on the trace's timeline; a
kernel belongs to a span when the host call that launched it (same
correlation id) lies inside that span.
"""

from __future__ import annotations

import gzip
import json
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
HOST_CATEGORIES = ("user_annotation", "cpu_op", "python_function") + LAUNCH_CATEGORIES
TOP = 10


def merge(intervals):
    """Sorted, disjoint union of ``(start, end)`` intervals."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def covered(merged, starts, start: float, end: float) -> float:
    """Length of ``[start, end]`` that the merged intervals (and their
    ``starts``, an array) cover."""
    if not merged:
        return 0.0
    i = max(int(np.searchsorted(starts, start, "right")) - 1, 0)
    total = 0.0
    while i < len(merged) and merged[i][0] < end:
        total += max(0.0, min(end, merged[i][1]) - max(start, merged[i][0]))
        i += 1
    return total


@dataclass
class TraceSummary:
    """Times in seconds over the traced window."""

    window_s: float = 0.0
    busy_s: float = 0.0
    num_spans: dict = field(default_factory=dict)
    span_s: dict = field(default_factory=dict)  # host time per span name
    span_kernel_s: dict = field(default_factory=dict)  # kernels launched inside
    span_host_s: dict = field(default_factory=dict)  # span less device busy
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def load_events(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as handle:
        return json.load(handle)["traceEvents"]


def summarize(events: list) -> TraceSummary:
    spans = defaultdict(list)
    device, host, launches, kernels = [], [], {}, []
    for event in events:
        if event.get("ph") != "X":
            continue
        cat = str(event.get("cat", "")).lower()
        start = float(event["ts"]) * 1e-6
        end = start + float(event.get("dur", 0.0)) * 1e-6
        name = str(event.get("name", ""))
        correlation = (event.get("args") or {}).get("correlation")
        if cat in DEVICE_CATEGORIES:
            device.append((start, end, name))
            if cat == "kernel":
                kernels.append((correlation, end - start))
        elif cat == "user_annotation" and name.startswith("bench/"):
            spans[name[len("bench/"):]].append((start, end))
        if cat in HOST_CATEGORIES:
            host.append((start, end, name))
        if cat in LAUNCH_CATEGORIES and correlation is not None:
            launches[correlation] = start
    summary = TraceSummary()
    measurements = spans.get("measurement", [])
    if not measurements:
        return summary
    lo = min(s for s, _ in measurements)
    hi = max(e for _, e in measurements)
    summary.window_s = hi - lo
    busy = merge([(max(s, lo), min(e, hi)) for s, e, _ in device if e > lo and s < hi])
    summary.busy_s = sum(e - s for s, e in busy)
    busy_starts = np.array([s for s, _ in busy])

    for name, intervals in spans.items():
        intervals.sort()
        summary.num_spans[name] = len(intervals)
        summary.span_s[name] = sum(e - s for s, e in intervals)
        summary.span_host_s[name] = sum(
            (e - s) - covered(busy, busy_starts, s, e) for s, e in intervals)
        starts = np.array([s for s, _ in intervals])
        ends = np.array([e for _, e in intervals])
        inside = 0.0
        for correlation, seconds in kernels:
            launched = launches.get(correlation)
            if launched is None:
                continue
            i = int(np.searchsorted(starts, launched, "right")) - 1
            if i >= 0 and launched <= ends[i]:
                inside += seconds
        summary.span_kernel_s[name] = inside

    by_name = defaultdict(float)
    for s, e, name in device:
        if e > lo and s < hi:
            by_name[name] += min(e, hi) - max(s, lo)
    summary.device_ops = [[name, seconds] for name, seconds in
                          sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]
    gaps = []
    edges = [lo] + [x for interval in busy for x in interval] + [hi]
    for gap_start, gap_end in zip(edges[0::2], edges[1::2]):
        if gap_end > gap_start:
            gaps.append((gap_end - gap_start, gap_start))
    gaps.sort(reverse=True)
    host_start = np.array([h[0] for h in host]) if host else np.zeros(0)
    host_end = np.array([h[1] for h in host]) if host else np.zeros(0)
    for seconds, start in gaps[:TOP]:
        probe = start + 0.5 * seconds
        open_ = np.nonzero((host_start <= probe) & (host_end >= probe))[0]
        if len(open_):
            inner = open_[np.argmin(host_end[open_] - host_start[open_])]
            label = host[inner][2]
        else:
            label = "host (no traced op)"
        summary.idle_gaps.append([label, seconds])
    return summary
