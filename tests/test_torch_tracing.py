"""The port's spans and counters (``utils/tracing.py``) on the CPU.

A measurement under ``torch.profiler`` leaves every stage of the in-memory
path in the exported Chrome trace as a ``yawt/`` range, as often as the
stage runs and inside the span that caused it; without a profiler no span
reaches ``record_function``. The counters count the engine's work and the
caches a repeated measurement reuses: a second identical measurement
misses none.
"""

from __future__ import annotations

import torch_threads  # noqa: F401  (one torch thread per test process)
import json
import os
import sys
import threading
from collections import Counter

import pytest
import torch

from yet_another_wizz_tpu_torch.catalog import Catalog
from yet_another_wizz_tpu_torch.config import Configuration
from yet_another_wizz_tpu_torch.correlation.measurements import (
    PatchLinkage,
    autocorrelate,
    crosscorrelate,
)
from yet_another_wizz_tpu_torch.examples import generate_mock_data
from yet_another_wizz_tpu_torch.ops import paircount
from yet_another_wizz_tpu_torch.utils import tracing

SIZES = dict(num_reference=1500, num_unknown=2500, num_randoms=4000)
SEED = 5
NUM_PATCHES = 6
CONFIG = dict(
    rmin=[100, 300], rmax=[300, 1000], unit="kpc", rweight=-1.0,
    resolution=32, zmin=0.15, zmax=1.0, num_bins=4,
)

ROOT_CHILDREN = {"linkage", "count.dd", "count.dr", "count.rd", "count.rr"}
"""The spans whose parent is the call's root span."""

PARENTS = {
    "tiles": "count", "pairs": "count", "engine.queue": "count",
    "finalize": "count", "fetch": "finalize",
}
"""The parent of each stage inside a count (``count`` for any
``count.<kind>``)."""


@pytest.fixture(scope="module")
def mock():
    return generate_mock_data(**SIZES, seed=SEED)


def make_catalogs(mock):
    reference = Catalog.from_arrays(
        **mock["reference"], degrees=False, patch_num=NUM_PATCHES, device="cpu"
    )
    centers = reference.get_centers()
    return (reference,) + tuple(
        Catalog.from_arrays(
            **mock[name], degrees=False, patch_centers=centers, device="cpu"
        )
        for name in ("unknown", "randoms")
    )


@pytest.fixture(scope="module")
def catalogs(mock):
    return make_catalogs(mock)


@pytest.fixture(scope="module")
def config():
    return Configuration.create(**CONFIG)


def measure(kind, config, catalogs):
    reference, unknown, randoms = catalogs
    if kind == "cross":
        return crosscorrelate(config, reference, unknown, ref_rand=randoms, device="cpu")
    return autocorrelate(config, reference, randoms, device="cpu")


def traced_spans(tmp_path, run) -> list[dict]:
    """The ``yawt/`` ranges of ``run()``'s exported Chrome trace, each with
    the name of its parent (the innermost ``yawt/`` range around it on its
    thread, None for a root)."""
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]
    ) as profiler:
        run()
    path = tmp_path / "trace.json"
    profiler.export_chrome_trace(str(path))
    events = [
        dict(name=e["name"][len(tracing.PREFIX):], tid=e["tid"],
             start=float(e["ts"]), end=float(e["ts"]) + float(e.get("dur", 0)))
        for e in json.loads(path.read_text())["traceEvents"]
        if e.get("ph") == "X" and str(e.get("name", "")).startswith(tracing.PREFIX)
    ]
    events.sort(key=lambda e: (e["tid"], e["start"], -e["end"]))
    stack: list[dict] = []
    for event in events:
        while stack and (
            stack[-1]["tid"] != event["tid"] or stack[-1]["end"] < event["end"] - 1e-2
        ):
            stack.pop()
        event["parent"] = stack[-1]["name"] if stack else None
        stack.append(event)
    return events


@pytest.mark.parametrize("kind", ["cross", "auto"])
def test_every_stage_is_a_span_inside_its_cause(kind, config, catalogs, tmp_path):
    measure(kind, config, catalogs)  # warm: the caches are filled
    events = traced_spans(
        tmp_path, lambda: measure(kind, config, catalogs)[0].sample()
    )
    names = Counter(e["name"] for e in events)
    root = "crosscorrelate" if kind == "cross" else "autocorrelate"
    kinds = ("dd", "rd") if kind == "cross" else ("dd", "dr", "rr")
    counts = len(kinds)
    expected = {
        root: 1, "linkage": 1, "tiles": counts, "pairs": counts,
        "engine.queue": counts, "finalize": counts, "fetch": counts,
        "post.sample": 1,
        # each count type twice: while it is queued and while it is finished
        **{f"count.{k}": 2 for k in kinds},
    }
    assert dict(names) == expected
    for event in events:
        name, parent = event["name"], event["parent"]
        if name in (root, "post.sample"):
            assert parent is None, event
        elif name in ROOT_CHILDREN:
            assert parent == root, event
        else:
            assert parent.split(".")[0] == PARENTS[name], event


def test_span_totals_read_the_recording(config, catalogs):
    measure("cross", config, catalogs)
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]
    ) as profiler:
        measure("cross", config, catalogs)
    totals = tracing.span_totals(profiler)
    assert totals["count.dd"][0] == 2 and totals["tiles"][0] == 2
    # a parent lasts at least as long as what it holds
    assert totals["crosscorrelate"][1] >= totals["linkage"][1] > 0
    assert totals["finalize"][1] >= totals["fetch"][1] > 0


def test_no_span_without_a_profiler(config, catalogs, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert tracing.span("fetch") is tracing.span("tiles")  # the shared null context
    measure("cross", config, catalogs)[0].sample()


def test_a_repeated_measurement_misses_no_cache(mock, config):
    catalogs = make_catalogs(mock)  # nothing cached yet
    misses = {}
    for run in ("first", "second"):
        before = tracing.snapshot()
        measure("cross", config, catalogs)
        measure("auto", config, catalogs)
        counted = {
            name: value - before.get(name, 0)
            for name, value in tracing.snapshot().items()
        }
        misses[run] = {
            name: value for name, value in counted.items()
            if name.startswith("cache.miss.") and value
        }
        hits = sum(
            value for name, value in counted.items() if name.startswith("cache.hit.")
        )
        assert hits > 0
    assert set(misses["first"]) >= {
        "cache.miss.tiles", "cache.miss.pairs", "cache.miss.lanes",
        "cache.miss.pair_index",
    }
    assert misses["second"] == {}


def test_candidate_pairs_are_the_engine_work(config, catalogs):
    reference, unknown, randoms = catalogs
    links = PatchLinkage.from_catalogs(config, reference, unknown, randoms)
    stats = [
        links.engine_work_stats(reference, unknown),
        links.engine_work_stats(randoms, unknown),
    ]
    tracing.reset()
    measure("cross", config, catalogs)
    assert tracing.counters["engine.tile_pairs"] == sum(s["tile_pairs"] for s in stats)
    assert tracing.counters["engine.candidate_pairs"] == sum(
        s["candidate_pairs"] for s in stats
    )


def test_recorded_counts_what_the_recording_saw(config, catalogs):
    measure("cross", config, catalogs)  # counted before any recording
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        before = tracing.snapshot()
        measure("cross", config, catalogs)
        during = {
            name: value - before.get(name, 0)
            for name, value in tracing.snapshot().items()
            if value != before.get(name, 0)
        }
    assert tracing.recorded() == during
    assert during["engine.tile_pairs"] > 0


def test_audit_spans_and_bounded_records(config, catalogs, tmp_path):
    reference, unknown, randoms = catalogs
    paircount.reset_audit_stats()
    events = traced_spans(
        tmp_path,
        lambda: crosscorrelate(
            config, reference, unknown, ref_rand=randoms, device="cpu", audit=True
        ),
    )
    flags = [e for e in events if e["name"] == "audit.flag"]
    assert len(flags) == 2 and {e["parent"] for e in flags} == {"engine.queue"}
    recounts = [e for e in events if e["name"] == "audit.recount"]
    assert len(recounts) == sum(
        len(record["flagged_slots"]) > 0 for record in paircount.AUDIT_STATS
    )
    assert len(paircount.AUDIT_STATS) == 2
    assert all(
        set(record) == {"flagged_slots", "recount_workers"}
        for record in paircount.AUDIT_STATS
    )
    assert paircount.AUDIT_STATS.maxlen == paircount.AUDIT_STATS_KEPT


def test_counters_from_threads_lose_no_count():
    """More threads than cores add to one counter with a short switch
    interval: a lost update would show in the total."""
    tracing.reset()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(
                target=lambda: [tracing.count("test.threads") for _ in range(2000)]
            )
            for _ in range(4 * (os.cpu_count() or 1))
        ]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(thread.is_alive() for thread in threads)
    assert tracing.counters["test.threads"] == 2000 * len(threads)
