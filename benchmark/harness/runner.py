"""One run of one cell: set-up, the measured window, the check, the result.

The run makes its inputs from the seed, builds the system and warms up every
shape with one measurement (all of it set-up), then repeats the
measurement back to back, one client in a closed loop, until ``seconds``
have passed; the window ends with the last measurement. With ``trace`` the
window runs under the profiler and the run reports the per-layer metrics,
otherwise the end-to-end ones. After the window the program's state is
freed and the reference recomputes the measurement from the inputs; a
sample of the window's measurements, drawn from the seed, is held against
it.
"""

from __future__ import annotations

import gc
import gzip
import json
import os
import random
import shutil
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from harness import check, inputs, trace
from harness.registry import Registry
from harness.session import Output, Session, Spans, extract

FORBIDDEN = ("jax", "jaxlib", "flax", "yet_another_wizz_tpu")
PROGRAM = "yet_another_wizz_tpu_torch"
KEPT = 2
"""Measurements of the window drawn from the seed to be checked, besides
the last."""


class RunError(RuntimeError):
    """The run cannot produce a result."""


@dataclass
class RunData:
    """What the metric readers read."""

    cell: object
    setup_s: float
    window_s: float
    durations: list
    memory_peak_bytes: int
    window_peak_bytes: int
    works: list = field(default_factory=list)
    trace: trace.TraceSummary | None = None

    @property
    def num_measurements(self) -> int:
        return len(self.durations)


def log(message: str) -> None:
    print(message, file=sys.stderr, flush=True)


def device_info(device: str) -> dict:
    import torch

    if device == "cpu":
        return dict(platform="cpu", kind="cpu", count=1)
    info = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=1)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
        log(f"card: {smi}")
    except (OSError, subprocess.SubprocessError, IndexError) as error:
        log(f"card: nvidia-smi not readable ({error})")
    return info


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def pin_caches(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program builds its kernels under ``build/`` there itself)."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(root / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))


def check_program(root: Path) -> None:
    """The program has to be the checkout's own."""
    import importlib

    try:
        module = importlib.import_module(PROGRAM)
    except ImportError as error:
        raise RunError(f"the program '{PROGRAM}' is not in this checkout: {error}")
    where = Path(module.__file__).resolve()
    if root.resolve() not in where.parents:
        raise RunError(f"'{PROGRAM}' comes from {where}, not from {root}")


def run(args, root: Path, started: float, *, device: str = "cuda",
        registry: Registry | None = None) -> dict:
    """Run the cell ``args.workload`` once and return the result line's
    object; raises :class:`RunError` where no result may be printed."""
    import torch

    registry = registry or Registry(root)
    cell = registry.cell(args.workload)
    if device != "cpu":
        chips = int(cell.workload["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise RunError(f"the cell needs {chips} CUDA card(s); "
                           f"available: {torch.cuda.is_available()}, "
                           f"count: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    pin_caches(root)
    check_program(root)
    info = device_info(device)
    out_dir = Path(args.out) if args.out else root / "bench_out" / (
        f"{args.workload}.seed{args.seed}.trace{args.trace}")
    out_dir.mkdir(parents=True, exist_ok=True)

    spans = Spans()
    t0 = time.perf_counter()
    data = inputs.make_inputs(cell.config, args.seed)
    log(f"inputs: {time.perf_counter() - t0:.3f} s")
    session = Session(cell.config, cell.traffic, data, device, spans)
    t0 = time.perf_counter()
    session.setup()
    log(f"system set-up: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    session.measure()  # warm-up: builds kernels, tiles and lists
    log(f"warm-up measurement: {time.perf_counter() - t0:.3f} s")
    gc.collect()
    setup_peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0

    result, run_data, kept = window(args, cell, session, spans, device, out_dir)
    run_data.setup_s -= started
    run_data.memory_peak_bytes = max(setup_peak, run_data.window_peak_bytes)

    session.close()
    del session
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    numbers = dict.fromkeys(check.NUMBERS, 0.0)
    widest = 0.0
    references = {}  # one per set of patch centres the kept measurements used
    for output in kept:
        centers = output["centers"]
        tag = None if centers is None else centers.tobytes()
        if tag not in references:
            references[tag] = check.reference_measurement(
                cell.config, cell.traffic, data, device,
                bands=(cell.limits["edge_band"],), centers=centers)
        desired, run_data.works = references[tag]
        for name, value in check.compare(output, desired, cell.limits).items():
            numbers[name] = max(numbers[name], value)
        widest = max(widest, check.widest_count_gap(output, desired))
    log(f"widest gap of one pair count (not compared): {widest!r}")
    correct = check.judge(numbers, cell.limits) and result["failed"] == 0
    log(f"reference: {time.perf_counter() - t0:.3f} s, {len(kept)} measurements compared")

    metrics = {}
    for spec in (cell.per_layer if args.trace else cell.end_to_end):
        value = registry.reader(spec["name"])(run_data)
        if value is not None:
            metrics[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    info["memory_peak_bytes"] = int(run_data.memory_peak_bytes)
    if args.trace:
        info["busy_s"] = run_data.trace.busy_s
        info["window_s"] = run_data.trace.window_s
    result.update(correct=bool(correct), metrics=metrics, device=info)
    if args.trace:
        result["breakdown"] = {"device_ops": run_data.trace.device_ops,
                               "idle_gaps": run_data.trace.idle_gaps}
    result["checks"] = {name: {"value": numbers[name], "limit": cell.limits[name]}
                        for name in check.NUMBERS}
    (out_dir / "run.json").write_text(json.dumps(dict(
        result, durations=run_data.durations, works=run_data.works),
        indent=1, default=str))
    found = forbidden_modules()
    if found:
        raise RunError(f"modules of JAX or the JAX package are loaded: {found}")
    for name in check.NUMBERS:
        log(f"check {name}: {numbers[name]!r} (limit {cell.limits[name]!r})")
    return result


def window(args, cell, session, spans, device, out_dir):
    """The measured window; returns the result's counts, the readers' data
    and the measurements kept for the check."""
    import torch

    rng = random.Random(args.seed)
    kept_outputs: list = []
    profiler = None
    if args.trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device != "cpu":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.__enter__()
        spans.profiling = True
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_end = time.time()
    durations, attempted, failed = [], 0, 0
    start = time.perf_counter()
    last: Output | None = None
    while True:
        t0 = time.perf_counter()
        attempted += 1
        try:
            with spans.span("measurement"):
                output = session.measure()
        except Exception as error:  # a measurement that fails is counted
            failed += 1
            log(f"measurement {attempted} failed: {error!r}")
            output = None
        t1 = time.perf_counter()
        if output is not None:
            durations.append(t1 - t0)
            # reservoir sample of KEPT measurements, drawn from the seed
            if len(kept_outputs) < KEPT:
                kept_outputs.append(output)
            elif (slot := rng.randrange(len(durations))) < KEPT:
                kept_outputs[slot] = output
            last = output
        if t1 - start >= args.seconds:
            break
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    summary = None
    if profiler is not None:
        spans.profiling = False
        profiler.__exit__(None, None, None)
        path = str(out_dir / "trace.json")
        profiler.export_chrome_trace(path)
        summary = trace.summarize(trace.load_events(path))
        with open(path, "rb") as src, gzip.open(path + ".gz", "wb") as dst:
            shutil.copyfileobj(src, dst)
        os.remove(path)
    kept = [extract(o, cell.traffic) for o in kept_outputs]
    if last is not None and all(o is not last for o in kept_outputs):
        kept.append(extract(last, cell.traffic))
    result = {"attempted": attempted, "failed": failed}
    run_data = RunData(
        cell=cell, setup_s=setup_end, window_s=window_s, durations=durations,
        memory_peak_bytes=0, window_peak_bytes=peak, trace=summary,
    )
    return result, run_data, kept
