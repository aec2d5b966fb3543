"""The program's spans and counters as the benchmark reads them
(``harness/program_spans.py`` and the readers of the stages): self times
and the cover of ``bench/count`` on hand-built trace events, the existing
readers unchanged by the program's ranges, and a traced run on the CPU that
reports every metric of the stages."""

import json
import sys

import pytest

from conftest import ROOT, cpu_run
from harness import program_spans, trace
from harness.registry import Registry
from harness.runner import RunData

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = ("measurements.linkage_ms", "measurements.tiles_ms", "measurements.pairs_ms",
       "engine.queue_ms", "measurements.fetch_wait_ms", "measurements.finalize_ms",
       "post.sample_ms", "engine.reach_share", "measurements.cache_misses")
"""The metrics that read the program's own spans and counters."""
EXISTING = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]
            if m["name"] not in NEW]


def span(name, start, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "pid": 1,
            "tid": tid, "ts": start, "dur": dur}


def kernel(start, dur, correlation):
    return {"ph": "X", "cat": "kernel", "name": "paircount", "pid": 0, "tid": 7,
            "ts": start, "dur": dur, "args": {"correlation": correlation}}


def launch(start, correlation):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1,
            "tid": 1, "ts": start, "dur": 1, "args": {"correlation": correlation}}


BENCH = [
    span("bench/measurement", 0, 100), span("bench/count", 0, 60),
    span("bench/nz", 60, 40),
    launch(21, 1), kernel(25, 30, 1), launch(70, 2), kernel(72, 5, 2),
]
PROGRAM = [
    # thread 1: one call with two halves of a count and the post layer
    span("yawt/crosscorrelate", 1, 58), span("yawt/linkage", 2, 8),
    span("yawt/count.dd", 10, 20), span("yawt/tiles", 11, 2),
    span("yawt/pairs", 13, 7), span("yawt/engine.queue", 20, 9),
    span("yawt/count.dd", 40, 18), span("yawt/finalize", 41, 16),
    span("yawt/fetch", 42, 8), span("yawt/post.sample", 61, 19),
    # thread 2, at the same time: its own root, inside nothing of thread 1
    span("yawt/tiles", 5, 10, tid=2),
]


def test_self_times_and_cover_by_hand():
    spans = program_spans.summarize(BENCH + PROGRAM)
    us = 1e-6
    expected_self = {
        "crosscorrelate": 58 - 8 - 20 - 18, "linkage": 8,
        "count.dd": (20 - 2 - 7 - 9) + (18 - 16), "tiles": 2 + 10, "pairs": 7,
        "engine.queue": 9, "finalize": 16 - 8, "fetch": 8, "post.sample": 19,
    }
    assert spans.self_s == pytest.approx({k: v * us for k, v in expected_self.items()})
    assert spans.num == {"crosscorrelate": 1, "linkage": 1, "count.dd": 2,
                         "tiles": 2, "pairs": 1, "engine.queue": 1, "finalize": 1,
                         "fetch": 1, "post.sample": 1}
    assert spans.total_s["count.dd"] == pytest.approx(38 * us)
    # bench/count [0, 60] on thread 1: the stages cover [2, 30] and [40, 58]
    assert spans.count_s == pytest.approx(60 * us)
    assert spans.count_coverage == pytest.approx((28 + 18) / 60)


def run_data(events, works):
    return RunData(cell=None, setup_s=1.0, window_s=1e-4, durations=[1e-4],
                   memory_peak_bytes=1, window_peak_bytes=2**20, works=works,
                   trace=trace.summarize(events))


def test_existing_readers_read_the_same_with_the_program_spans():
    registry = Registry(ROOT)
    works = [dict(pairs_in_reach=1e6, num_points=1e5, binned=False, union_edges=4,
                  scale_edges=2, weighted=True, max_angle=1e-3, num_bins=3,
                  num_patches=4)]
    without = run_data(BENCH, works)
    with_program = run_data(BENCH + PROGRAM, works)
    read = 0
    for name in EXISTING:
        reader = registry.reader(name)
        value = reader(without)
        assert reader(with_program) == value, name
        read += value is not None
    assert read == len(EXISTING)  # each existing reader found its number


def test_readers_outside_a_run_or_without_the_program_find_nothing(monkeypatch):
    """Called with no run's output directory on the stack, or where the
    program has no counters (an older program), the readers return None."""
    registry = Registry(ROOT)
    data = run_data(BENCH + PROGRAM, [dict(pairs_in_reach=1)])
    monkeypatch.setitem(sys.modules, "yet_another_wizz_tpu_torch.utils.tracing", None)
    for name in NEW:
        assert registry.reader(name)(data) is None, name


def test_a_traced_cpu_run_reports_every_stage(tiny_root, tmp_path):
    result = cpu_run(tiny_root, "inmem_mock.multiscale", tmp_path, trace=1,
                     seconds=1.0)
    metrics = result["metrics"]
    for name in NEW:
        assert isinstance(metrics[name]["value"], float), name
        assert metrics[name]["value"] >= 0.0, name
    assert metrics["measurements.cache_misses"]["value"] == 0.0
    assert 0.0 < metrics["engine.reach_share"]["value"] <= 100.0
    spans = program_spans.summarize(trace.load_events(
        str(tmp_path / "inmem_mock.multiscale.1" / "trace.json.gz")))
    assert spans.count_coverage > 0.5
    assert spans.num["linkage"] == spans.num["crosscorrelate"] + spans.num["autocorrelate"]
