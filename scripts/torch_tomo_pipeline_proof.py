#!/usr/bin/env python3
"""Tomographic proof of the PyTorch port's command line at survey scale.

The port of the JAX package's ``scripts/tomo_pipeline_proof.py``: the
port's batch pipeline (``python -m yet_another_wizz_tpu_torch.cli``) runs
the tomographic task graph over 30M rows by default (``--rows``), 4
unknown bins (``--bins``), 96 kmeans patches, blocked with 24 resident
patches and lazy catalogs:

1. ``prepare``: a mock from ``generate_mock_data(seed=779)`` (reference
   15 %, unknown 35 % split into ``--bins`` slices by quantiles of its
   redshift, randoms 50 %) goes to chunked Parquet files (row groups of 2M
   rows), with stride-``--downsample`` copies of every file.
2. The setup, in the JAX package's schema (``execution:
   {max_resident_patches: 24, lazy: true}``, tasks ``auto_ref``,
   ``cross_corr``, ``estimate``, ``hist``), runs through the command
   line's ``main`` in a subprocess of this script, once on the full inputs
   and once on the downsample. The subprocess stores the pair counts
   through ``h5py`` or, where it is not installed, the stand-in of
   ``scripts/torch_h5py_standin.py``, and reports its kernel launches, the
   session tile cache's hits and rebuilds, its peak device memory and its
   host memory growth over a baseline taken after CUDA is initialised and
   a small measurement has run on the card.
   Per-task and per-bin seconds come from ``pipeline.log``.
3. Gates (as in the JAX script): every bin's n(z) is finite and peaks
   where its slice has true-z support, and the mean error-aware reduced
   chi^2 of full against downsample is < 3; besides, on the card K1.1,
   K1.2 and kernel B launched in both runs and the plain engine never ran
   there. A failed gate exits non-zero and writes no record.

Not ported: the compile-cache environment (the TPU's remote-compile
service, ROADMAP R1); the parent's ``ru_maxrss`` of its children (on a
card's machine the CUDA libraries set it at start-up), whose place the
subprocess's own ``VmRSS`` samples take.

Run (the work directory, under the system temp directory, is removed at
the end unless ``--keep``; it needs about 100 bytes per row of disk)::

    python scripts/torch_tomo_pipeline_proof.py [--rows 30000000] [--bins 4] \\
        [--device cuda] [--out PROOF_torch_tomo30m.json]
    python scripts/torch_tomo_pipeline_proof.py --small --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from datetime import datetime
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "scripts")]

from torch_proof_common import (  # noqa: E402
    EngineSpy,
    MemorySampler,
    card,
    host_memory,
    launches,
    log,
    machine,
    memory_growth,
    require_device,
    rounded,
    warm_up,
    write_parquet_chunked,
)

SEED = 779
NUM_CLUSTERS = 3000
TASKS = ["auto_ref", "cross_corr", "estimate", "hist"]
SMALL = dict(rows=300_000, patches=16, resident=6, downsample=8)
"""``--small`` (the JAX script's smoke scale): every patch stays populated
at smoke statistics."""
CHI2_LIMIT = 3.0
KERNELS = ("paircount_partials", "paircount_partials_binned", "paircount_segment_sum")
"""K1.1 (``cross_corr``), K1.2 (``auto_ref``) and kernel B."""


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rows", type=int, default=30_000_000)
    parser.add_argument("--bins", type=int, default=4)
    parser.add_argument("--small", action="store_true",
                        help="300k-row smoke run of the whole machinery")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--patches", type=int, default=96)
    parser.add_argument("--resident", type=int, default=24,
                        help="execution.max_resident_patches of the setup")
    parser.add_argument("--downsample", type=int, default=64)
    parser.add_argument("--workdir", default=None,
                        help="default: a new directory under the system temp directory")
    parser.add_argument("--keep", action="store_true", help="keep the work directory")
    parser.add_argument("--out", default=None)
    parser.add_argument("--pipeline-child", nargs=3, metavar=("PROJECT", "SETUP", "STATS"),
                        help=argparse.SUPPRESS)  # the command line's subprocess
    args = parser.parse_args(argv)
    if args.small:
        for key, value in SMALL.items():
            setattr(args, key, value)
    return args


def prepare(workdir: Path, args) -> dict:
    """Generate the mock, slice the unknown sample, write Parquet."""
    from yet_another_wizz_tpu_torch.examples import generate_mock_data

    num_reference = int(args.rows * 0.15)
    num_unknown = int(args.rows * 0.35)
    t0 = time.perf_counter()
    log(f"generating mock samples ({args.rows} rows in all)")
    mock = generate_mock_data(
        num_reference=num_reference, num_unknown=num_unknown,
        num_randoms=args.rows - num_reference - num_unknown,
        num_clusters=NUM_CLUSTERS, seed=SEED,
    )
    t_gen = time.perf_counter() - t0

    # tomographic slices by quantiles of the unknown sample's redshifts;
    # each slice keeps its true redshifts for the hist task
    unknown = mock["unknown"]
    quantiles = np.quantile(unknown["redshifts"], np.linspace(0.0, 1.0, args.bins + 1))
    sources = {name: mock[name] for name in ("reference", "randoms")}
    for index in range(1, args.bins + 1):
        lo, hi = quantiles[index - 1], quantiles[index]
        upper = (unknown["redshifts"] <= hi if index == args.bins
                 else unknown["redshifts"] < hi)
        keep = (unknown["redshifts"] >= lo) & upper
        sources[f"unknown_{index}"] = {key: value[keep] for key, value in unknown.items()}

    t0 = time.perf_counter()
    rows = {}
    for name, sample in sources.items():
        rows[name] = len(sample["ra"])
        write_parquet_chunked(workdir / f"{name}.pqt", sample)
        small = {key: np.ascontiguousarray(value[:: args.downsample])
                 for key, value in sample.items()}
        write_parquet_chunked(workdir / f"small_{name}.pqt", small)
    t_write = time.perf_counter() - t0
    return {
        "rows": rows,
        "tomographic_edges": [float(f"{q:.4f}") for q in quantiles],
        "generate_s": round(t_gen, 1),
        "parquet_write_s": round(t_write, 1),
    }


def write_setup(workdir: Path, path: Path, args, *, small: bool) -> None:
    """The setup file in the JAX package's schema."""
    import yaml

    prefix = "small_" if small else ""
    setup = dict(
        correlation=dict(
            scales=dict(rmin=100, rmax=1000, unit="kpc"),
            binning=dict(zmin=0.15, zmax=1.0, num_bins=11),
        ),
        inputs=dict(
            reference=dict(
                path_data=str(workdir / f"{prefix}reference.pqt"),
                path_rand=str(workdir / f"{prefix}randoms.pqt"),
                ra="ra", dec="dec", redshift="z", weight="w",
            ),
            unknown=dict(
                path_data={
                    index: str(workdir / f"{prefix}unknown_{index}.pqt")
                    for index in range(1, args.bins + 1)
                },
                ra="ra", dec="dec", redshift="z", weight="w",
            ),
            num_patches=args.patches,
        ),
        execution=dict(max_resident_patches=args.resident, lazy=True),
        tasks=TASKS,
    )
    with path.open("w") as f:
        yaml.safe_dump(setup, f)


_TASK_LINE = re.compile(
    r"^(\S+ \S+) \w+ \S+ (?:running task '(\w+)'"
    r"|task '(\w+)' finished after)"
)


def parse_task_walls(log_path: Path) -> dict[str, float]:
    """Per-task wall seconds from the pipeline.log timestamp pairs."""
    started: dict[str, datetime] = {}
    walls: dict[str, float] = {}
    for line in log_path.read_text().splitlines():
        match = _TASK_LINE.match(line)
        if match is None:
            continue
        stamp = datetime.strptime(match.group(1), "%Y-%m-%d %H:%M:%S,%f")
        if match.group(2):
            started[match.group(2)] = stamp
        elif match.group(3) in started:
            name = match.group(3)
            delta = (stamp - started.pop(name)).total_seconds()
            walls[name] = round(walls.get(name, 0.0) + delta, 1)
    return walls


_BIN_LINE = re.compile(r"^(\S+ \S+) \w+ \S+ processing bin (\d+) / (\d+)")


def parse_bin_walls(log_path: Path) -> dict[str, list[float]]:
    """Per-bin marginal wall seconds inside each tomographic task, from
    the ``processing bin i / N`` lines: bin i spans its own line to the
    next bin's line (or the task's ``finished`` line)."""
    walls: dict[str, list[float]] = {}
    task = None
    bin_start = None
    for line in log_path.read_text().splitlines():
        task_match = _TASK_LINE.match(line)
        if task_match is not None:
            stamp = datetime.strptime(task_match.group(1), "%Y-%m-%d %H:%M:%S,%f")
            if task_match.group(2):
                task = task_match.group(2)
                bin_start = None
            elif task is not None and bin_start is not None:
                walls.setdefault(task, []).append(
                    round((stamp - bin_start).total_seconds(), 1)
                )
                task, bin_start = None, None
            continue
        bin_match = _BIN_LINE.match(line)
        if bin_match is not None and task is not None:
            stamp = datetime.strptime(bin_match.group(1), "%Y-%m-%d %H:%M:%S,%f")
            if bin_start is not None:
                walls.setdefault(task, []).append(
                    round((stamp - bin_start).total_seconds(), 1)
                )
            bin_start = stamp
    return walls


def pipeline_child(project: str, setup: str, stats: str, device: str) -> int:
    """The command line's subprocess: ``commandline.main`` with the launch
    counts set to 0 just before it; its statistics go to ``stats``."""
    from torch_h5py_standin import ensure_h5py

    h5py_used = ensure_h5py()
    import torch

    from yet_another_wizz_tpu_torch.cli.commandline import main as cli_main
    from yet_another_wizz_tpu_torch.correlation import blocked
    from yet_another_wizz_tpu_torch.ops import cuda_paircount

    on_card = torch.device(device).type == "cuda"
    if on_card:
        cuda_paircount.build()
        warm_up(device)
        torch.cuda.reset_peak_memory_stats()
    tile_caches = []
    original = blocked.measurement_tile_cache

    def recording(*args, **kwargs):
        context = original(*args, **kwargs)

        class Recorder:
            def __enter__(self):
                cache = context.__enter__()
                tile_caches.append(cache)
                return cache

            def __exit__(self, *exc):
                return context.__exit__(*exc)

        return Recorder()

    base = host_memory()
    blocked.measurement_tile_cache = recording
    try:
        with EngineSpy() as spy, MemorySampler() as memory:
            cuda_paircount.reset_launch_counts()
            t0 = time.perf_counter()
            code = cli_main([project, setup, "--device", device, "--quiet"])
            if on_card:
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counted = launches()
    finally:
        blocked.measurement_tile_cache = original
    Path(stats).write_text(json.dumps({
        "exit_code": code,
        "seconds": seconds,
        "h5py": h5py_used,
        "launches": counted,
        "kernel_devices": sorted(spy.kernel_devices),
        "plain_engine_devices": sorted(spy.plain_devices),
        "tile_cache": {
            "caches": len(tile_caches),
            "hits": sum(c.hits for c in tile_caches),
            "rebuilds": sum(c.misses for c in tile_caches),
        },
        "host_base": base,
        "host_peak": memory.peak,
        "device_peak_bytes": int(torch.cuda.max_memory_allocated()) if on_card else None,
    }))
    return code


def run_pipeline(workdir: Path, project: Path, args, rows: int, *, small: bool) -> dict:
    """The command line over one setup, in a subprocess of this script."""
    setup_path = workdir / ("small_setup.yml" if small else "setup.yml")
    write_setup(workdir, setup_path, args, small=small)
    shutil.rmtree(project, ignore_errors=True)
    stats_path = workdir / f"stats_{project.name}.json"
    t0 = time.perf_counter()
    result = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--device", args.device,
         "--pipeline-child", str(project), str(setup_path), str(stats_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, check=False,
    )
    wall = time.perf_counter() - t0
    if result.returncode != 0:
        raise SystemExit(f"the pipeline failed:\n{result.stdout[-3000:]}\n"
                         f"{result.stderr[-3000:]}")
    stats = json.loads(stats_path.read_text())
    return {
        "wall_s": round(wall, 1),
        "main_s": round(stats["seconds"], 1),
        "task_walls_s": parse_task_walls(project / "pipeline.log"),
        "bin_walls_s": parse_bin_walls(project / "pipeline.log"),
        "peak_host_rss_gb": round(stats["host_peak"]["VmRSS"] / 1e9, 3),
        "host_memory": memory_growth(stats["host_base"], stats["host_peak"], rows),
        "device_peak_bytes": stats["device_peak_bytes"],
        "launches": stats["launches"],
        "kernel_devices": stats["kernel_devices"],
        "plain_engine_devices": stats["plain_engine_devices"],
        "tile_cache": stats["tile_cache"],
        "pair_counts_stored_through": stats["h5py"],
    }


def load_estimates(project: Path, num_bins: int) -> dict:
    """Per-bin estimated n(z) and normalised true-z histogram."""
    from yet_another_wizz_tpu_torch.redshifts import HistData, RedshiftData

    out = {}
    for index in range(1, num_bins + 1):
        nz = RedshiftData.from_files(project / "estimate" / f"nz_est_{index}")
        hist = HistData.from_files(project / "true" / f"nz_true_{index}")
        out[index] = dict(
            nz_data=np.asarray(nz.data),
            nz_error=np.asarray(nz.error),
            hist_data=np.asarray(hist.normalised().data),
        )
    return out


def compare_bins(full: dict, down: dict) -> tuple[dict, float]:
    """Each bin's gate values, and the mean chi^2 of full against
    downsample."""
    bins, chi2s = {}, []
    for index, f in full.items():
        d = down[index]
        err = np.hypot(f["nz_error"], d["nz_error"])
        # bins where the slice has no support hold noise around zero in
        # both runs; the error-aware chi^2 handles them without masking
        chi2 = float(np.mean(((f["nz_data"] - d["nz_data"]) / err) ** 2))
        peak = int(np.argmax(f["nz_data"]))
        chi2s.append(chi2)
        bins[index] = {
            "nz_finite": bool(np.all(np.isfinite(f["nz_data"]))),
            "nz_data": rounded(f["nz_data"]),
            "nz_error": rounded(f["nz_error"]),
            "full_vs_downsample_chi2": round(chi2, 3),
            "peak_bin_has_true_support": bool(f["hist_data"][peak] > 0),
        }
    return bins, float(np.mean(chi2s))


def gate_failures(record: dict) -> list[str]:
    """Every gate the record fails (none for a sound run)."""
    failures = []
    for index, info in record["bins"].items():
        if not info["nz_finite"]:
            failures.append(f"bin {index}: non-finite n(z)")
        if not info["peak_bin_has_true_support"]:
            failures.append(f"bin {index}: n(z) peak outside the slice")
    chi2 = record["mean_full_vs_downsample_chi2"]
    if not chi2 < CHI2_LIMIT:
        failures.append(f"full vs downsampled n(z) inconsistent (mean reduced chi2 {chi2})")
    for key in ("pipeline", "downsample_pipeline"):
        run = record[key]
        plain = [d for d in run["plain_engine_devices"] if d.startswith("cuda")]
        if plain:
            failures.append(f"{key}: the plain engine ran on {plain}")
        if record["device"].startswith("cuda"):
            missing = [k for k in KERNELS if not run["launches"].get(k)]
            if missing:
                failures.append(f"{key}: {missing} never launched")
    return failures


def main(argv=None) -> int:
    args = parse_args(argv)
    require_device(args.device)
    if args.pipeline_child:
        return pipeline_child(*args.pipeline_child, args.device)

    workdir = Path(args.workdir or tempfile.mkdtemp(prefix="yawt_torch_tomo_proof_"))
    workdir.mkdir(parents=True, exist_ok=True)
    record = {
        "config": "torch_tomographic_cli_proof",
        "total_rows_requested": args.rows,
        "num_tomographic_bins": args.bins,
        "num_patches": args.patches,
        "max_resident_patches": args.resident,
        "downsample_stride": args.downsample,
        "tasks": TASKS,
        "device": args.device,
        "card": card(args.device),
        "machine": machine(workdir),
        "workdir": str(workdir),
    }
    log(f"card: {record['card']}; machine: {record['machine']}")
    try:
        t0 = time.perf_counter()
        record["prepare"] = prepare(workdir, args)
        log(f"prepare: {record['prepare']}")
        rows = sum(record["prepare"]["rows"].values())
        small_rows = sum(-(-n // args.downsample) for n in record["prepare"]["rows"].values())
        record["pipeline"] = run_pipeline(workdir, workdir / "project", args, rows, small=False)
        log(f"pipeline: {record['pipeline']}")
        record["downsample_pipeline"] = run_pipeline(
            workdir, workdir / "project_small", args, small_rows, small=True
        )
        log(f"downsample pipeline: {record['downsample_pipeline']}")
        record["disk_used_bytes"] = sum(
            f.stat().st_size for f in workdir.rglob("*") if f.is_file()
        )
        full = load_estimates(workdir / "project", args.bins)
        down = load_estimates(workdir / "project_small", args.bins)
        record["total_s"] = round(time.perf_counter() - t0, 1)
    finally:
        if not args.keep:
            shutil.rmtree(workdir, ignore_errors=True)
    record["bins"], mean_chi2 = compare_bins(full, down)
    record["mean_full_vs_downsample_chi2"] = round(mean_chi2, 3)
    failures = gate_failures(record)
    if failures:
        for failure in failures:
            log(f"GATE FAILED: {failure}")
        return 1
    record["timestamp"] = time.strftime("%Y-%m-%d %H:%M:%S UTC", time.gmtime())
    out = Path(args.out or Path(tempfile.gettempdir()) / "torch_tomo_proof.json")
    out.write_text(json.dumps(record, indent=1) + "\n")
    log(f"every gate passed; record written: {out}")
    print(json.dumps({key: record[key] for key in (
        "total_rows_requested", "mean_full_vs_downsample_chi2")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
