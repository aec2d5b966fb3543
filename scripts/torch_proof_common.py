"""What the PyTorch port's survey-scale proofs share
(``scripts/torch_survey_proof.py``, ``scripts/torch_tomo_pipeline_proof.py``):
the device check, the card and machine they ran on, a warm-up on the card, host memory
read from ``/proc/self``, a spy on the engine's kernel wrappers and plain version,
and the chunked Parquet writer. Imports neither ``jax`` nor the JAX
package; ``torch`` and ``pyarrow`` only inside the functions that use them.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

PARQUET_CHUNK = 2_000_000
"""Rows per Parquet row group (the JAX proofs' ``PARQUET_CHUNK``)."""


def log(message: str) -> None:
    print(message, file=sys.stderr, flush=True)


def require_device(device: str) -> None:
    """Raise ``SystemExit`` for a CUDA ``device`` without CUDA: the proofs
    run where they are asked to, never on the CPU instead."""
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"CUDA is not available: --device {device} needs an NVIDIA card")


def card(device: str) -> str | None:
    """``name, power limit`` of the card as ``nvidia-smi`` reports them
    (``--query-gpu=name,power.limit --format=csv,noheader``), or None off
    the card."""
    import torch

    if torch.device(device).type != "cuda":
        return None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return smi.stdout.strip().splitlines()[0]


def machine(workdir) -> dict:
    """The host a proof ran on: its RAM (``MemTotal``, ``MemAvailable``),
    the disk free in the work directory, and ``nproc``."""
    meminfo = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            if key in ("MemTotal", "MemAvailable"):
                meminfo[key] = int(value.split()[0]) * 1024
    return {
        "ram_total_bytes": meminfo.get("MemTotal"),
        "ram_available_bytes": meminfo.get("MemAvailable"),
        "disk_free_bytes": shutil.disk_usage(workdir).free,
        "nproc": len(os.sched_getaffinity(0)),
    }


MEMORY_KINDS = ("VmRSS", "RssAnon", "RssFile", "RssShmem")
"""The resident-memory lines of ``/proc/self/status`` read (``VmRSS``: all
of it; where the kernel reports them, ``RssAnon``, ``RssFile``,
``RssShmem``). ``ru_maxrss`` is not read: on a card's machine the CUDA
libraries set it at start-up."""


def host_memory() -> dict:
    """This process's resident memory now, in bytes, by the kinds of
    :data:`MEMORY_KINDS` its ``/proc/self/status`` reports; ``VmRSS`` from
    ``/proc/self/statm`` when the status has no such line."""
    sizes = {}
    with open("/proc/self/status") as f:
        for line in f:
            key, _, value = line.partition(":")
            if key in MEMORY_KINDS:
                sizes[key] = int(value.split()[0]) * 1024
    if "VmRSS" not in sizes:
        with open("/proc/self/statm") as f:
            sizes["VmRSS"] = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    return sizes


class MemorySampler:
    """The largest :func:`host_memory` of each kind seen by a thread that
    samples it every 20 ms while the ``with`` block runs."""

    def __init__(self) -> None:
        self.peak = host_memory()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)

    def _sample(self) -> None:
        while not self._stop.wait(0.02):
            for key, value in host_memory().items():
                self.peak[key] = max(self.peak.get(key, 0), value)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        for key, value in host_memory().items():
            self.peak[key] = max(self.peak.get(key, 0), value)


def memory_growth(base: dict, peak: dict, rows: int) -> dict:
    """The peak's growth over ``base`` (``VmRSS``), in bytes and per row."""
    growth = peak["VmRSS"] - base["VmRSS"]
    return {
        "baseline_vmrss_bytes": base["VmRSS"],
        "peak_vmrss_bytes": peak["VmRSS"],
        "growth_bytes": growth,
        "bytes_per_row": round(growth / rows, 2),
    }


class EngineSpy:
    """Inside the ``with`` block: the devices the kernel wrappers were
    called on, and the devices the plain engine was called on."""

    PLAIN = ("count_pairs_torch", "partial_counts_torch", "segment_sum_torch")

    def __init__(self) -> None:
        self.kernel_devices: set = set()
        self.plain_devices: set = set()
        self._saved: list = []

    def _wrap(self, module, name: str, record: set) -> None:
        original = getattr(module, name)

        def spy(first, *args, **kwargs):
            record.add(str(first.device))
            return original(first, *args, **kwargs)

        self._saved.append((module, name, original))
        setattr(module, name, spy)

    def __enter__(self):
        from yet_another_wizz_tpu_torch.ops import cuda_paircount, paircount
        from yet_another_wizz_tpu_torch.parallel import sharded

        for name in ("paircount_partials", "segment_sum"):
            self._wrap(cuda_paircount, name, self.kernel_devices)
        for module in (paircount, cuda_paircount, sharded):
            for name in self.PLAIN:
                if hasattr(module, name):
                    self._wrap(module, name, self.plain_devices)
        return self

    def __exit__(self, *exc) -> None:
        for module, name, original in reversed(self._saved):
            setattr(module, name, original)


def host_spans(run) -> tuple:
    """``(result, seconds, spans)``: ``run()`` under a profiler of the host,
    its host seconds (the profiler's cost included) and the port's span
    totals in it (``{name: (count, seconds)}``, names without ``yawt/``)."""
    import torch

    from yet_another_wizz_tpu_torch.utils import tracing

    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]
    ) as profiler:
        t0 = time.perf_counter()
        result = run()
        seconds = time.perf_counter() - t0
    return result, seconds, tracing.span_totals(profiler)


def launches() -> dict:
    """The kernel launches counted since the counters' last reset
    (``tracing.reset()``), by variant."""
    from yet_another_wizz_tpu_torch.ops.cuda_paircount import LAUNCHES
    from yet_another_wizz_tpu_torch.utils import tracing

    return {
        key[len(LAUNCHES):]: value for key, value in tracing.snapshot().items()
        if key.startswith(LAUNCHES) and value
    }


def warm_up(device: str) -> None:
    """Blocked ``crosscorrelate`` and ``autocorrelate`` on small in-memory
    mocks (20k / 40k / 80k rows, 16 kmeans patches) on ``device``, so that
    what the CUDA libraries take on first use is in a host-memory
    baseline taken after it."""
    from yet_another_wizz_tpu_torch.catalog import Catalog
    from yet_another_wizz_tpu_torch.config import Configuration
    from yet_another_wizz_tpu_torch.correlation.measurements import (
        autocorrelate,
        crosscorrelate,
    )
    from yet_another_wizz_tpu_torch.examples import generate_mock_data

    config = Configuration.create(
        rmin=100, rmax=1000, unit="kpc", zmin=0.15, zmax=1.0, num_bins=11
    )
    mock = generate_mock_data(20_000, 40_000, 80_000, seed=1)
    reference = Catalog.from_arrays(
        **mock["reference"], degrees=False, patch_num=16, device=device
    )
    unknown, randoms = (
        Catalog.from_arrays(**mock[name], degrees=False,
                            patch_centers=reference.get_centers(), device=device)
        for name in ("unknown", "randoms")
    )
    crosscorrelate(config, reference, unknown, ref_rand=randoms,
                   max_resident_patches=6, device=device)
    autocorrelate(config, reference, randoms, max_resident_patches=6, device=device)


def write_parquet_chunked(path, sample: dict, row_group: int = PARQUET_CHUNK) -> None:
    """Write one sample (radian ``ra``/``dec``, ``redshifts``, ``weights``)
    as Parquet in row groups of ``row_group`` rows, angles in degrees."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    n = len(sample["ra"])
    writer = None
    try:
        for start in range(0, n, row_group):
            stop = min(start + row_group, n)
            table = pa.table(dict(
                ra=np.rad2deg(sample["ra"][start:stop]),
                dec=np.rad2deg(sample["dec"][start:stop]),
                z=sample["redshifts"][start:stop],
                w=sample["weights"][start:stop],
            ))
            if writer is None:
                writer = pq.ParquetWriter(path, table.schema)
            writer.write_table(table)
    finally:
        if writer is not None:
            writer.close()


def rounded(values, digits: int = 6) -> list:
    """A list of floats with ``digits`` significant digits (the records'
    n(z) columns)."""
    return [float(f"{v:.{digits}g}") for v in np.asarray(values).ravel()]
