#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``yet_another_wizz_tpu_torch``) on one
NVIDIA card.

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit::

    python3 chip_smoke.py

It builds the CUDA kernels from ``yet_another_wizz_tpu_torch/csrc`` (one
``nvcc`` per counting mode, started together), holds every variant of the
pair-count kernel against its plain PyTorch version on the card, on the
inputs of its path, and drives each path once at the size of the JAX
package's benchmark (200k reference, 500k unknown, 1M random points, 64
kmeans patches, 11 redshift bins), through the entry points a user calls:

- the main path (slice 1): ``crosscorrelate`` DD + RD ->
  ``RedshiftData.from_corrfuncs`` with jackknife (kernel K1.1);
- w_ss: ``autocorrelate`` DD + DR + RR (Landy-Szalay) ->
  ``from_corrfuncs(w_sp, ref_corr=w_ss)`` (binned columns, K1.2);
- config B: three scales with ``rweight=-1`` at resolution 32, which the
  ``auto`` counting mode runs in direct mode: ``crosscorrelate`` and
  ``autocorrelate`` -> n(z) per scale (K1.3, unbinned and binned);
- scalar: ``crosscorrelate_scalar`` (``kn``, with randoms) and
  ``autocorrelate_scalar`` (``kk``) on a reference with signed kappa
  (K1.5: K1.1 and K1.2 with signed weights);
- wide grid: scales up to 1.35 rad, wider than the small-angle index
  covers: ``crosscorrelate`` and ``autocorrelate`` (K1.4, the arcsine
  index, unbinned and binned);
- many scales: ten overlapping scales between 100 and 2,000 kpc with
  ``rweight=-1`` at resolution 32, 18 above-entries per bin:
  ``crosscorrelate`` (K1.3 in two launches per count), its counts held
  against the union-edge cumulative counts;
- survey: the JAX package's survey-scale bench (``bench.py:465-602``,
  BASELINE config 5 on one card): 1M reference + 2M unknown from
  ``generate_mock_data(seed=777)`` and 4M ``HealPixRandoms`` (nside 128,
  ra 40-60 deg, dec -10-10 deg, seed 199), 96 kmeans patches, disk caches
  in a temporary directory; ``crosscorrelate(max_resident_patches=24)``
  (the blocked out-of-core path, K1.1 once per block pair) on the caches
  opened as ``Catalog``, then, in child processes that report their peak
  host memory, as ``Catalog`` and as ``LazyCatalog`` with the packed-tile
  store warm. Its counts are held against the in-memory path and the
  float64 oracle on 48 slots, the lazy and store-hit runs bitwise against
  the first; it logs the phases of each run, the engine's kernel time, the
  side-stream upload time of a run without the tile store, and the cache
  hits. It then runs the survey under a resident budget below its lanes
  (evictions, disk spills and reloads; bitwise the first run) and with both
  budgets 0, and ``HistData.from_catalog`` on the unknown sample from
  ``Catalog`` and ``LazyCatalog`` (bitwise equal, each bin the sample's
  weight sum);
- sharded: on a mesh of four shards (the first four cards, or
  four entries of ``cuda:0`` on a machine with fewer), the headline
  ``crosscorrelate`` + n(z) under the ``replicated``, ``columns`` and
  ``ring`` layouts, ``autocorrelate`` (K1.2) and config B's
  ``crosscorrelate`` (K1.3) under ``ring``: counts and n(z) against the
  single-device runs (1e-6, direct 1e-5), two runs of each bitwise equal,
  K1.x and kernel B launched once per non-empty shard and step, the warm
  median of 3 beside the single-device one; and the cross-shard sum timed
  against its byte bound;
- two processes: the headline catalogs written to caches
  (``Catalog.to_cache``) and counted here on one process's mesh of four
  shards in every layout; two children of the script (``--mp-child``),
  wired by ``YAWT_*`` over gloo on localhost, each on ``cuda:rank`` (or
  ``cuda:0`` on a one-card machine), open the caches and must reproduce
  those counts bit for bit on the global mesh of 2 x 2 shards; a child's
  failure fails the script;
- survey, sharded: the survey's blocked ``crosscorrelate`` under ``ring``
  on four shards, twice, against its single-device counts (1e-6) and
  bitwise against each other;
- audit: the main path with ``audit=True`` (the flag pass K2.1 through
  the flag kernel on the card, the flagged slots recounted in float64):
  flagged slots equal the oracle, the others the unaudited counts bit for
  bit, and every slot lies within 1e-6 of the oracle; the engineered
  on-edge pair of the JAX package's audit tests
  (``tests/torch_audit_cases.py``), which K1.1 counts on the wrong side of
  the edge and the audit repairs; and blocked ``autocorrelate(audit=True)``
  against the in-memory audited run, on the benchmark's reference and
  randoms halved. Each of the three launches the flag kernel, never runs
  the plain flag pass on the card (a spy), and flags the same slots as a
  rerun with the plain flag pass.
- batch pipeline: the JAX package's setup schema and project layout,
  through the command line's ``main`` (``python -m
  yet_another_wizz_tpu_torch.cli``) with ``--device cuda``, at the
  benchmark's size: the mock written as FITS (reference with randoms,
  the unknown sample in 4 tomographic bins by quantiles of its redshift),
  64 kmeans patches, tasks ``auto_ref`` (K1.2), ``cross_corr`` (K1.1),
  ``estimate``, ``hist`` and ``plot``. Run A in memory; B blocked with
  lazy catalogs (``max_resident_patches: 24``, one session tile cache);
  C ``--resume`` of A; D ``--profile`` of A's counting tasks on a copy of
  its project. A's pair counts equal, bit for bit, ``crosscorrelate`` /
  ``autocorrelate`` on the project's own caches, its estimate and
  histogram files byte for byte those written from them; bin 1's cross
  DD on 48 slots lies within 1e-6 of the float64 oracle; B within 1e-6
  of A; C skips every task but ``plot`` and launches nothing; D's trace
  names K1.x and kernel B as CUDA kernels. No plain-engine call runs on
  the card and every launch names ``cuda:0``. Where ``h5py`` is not
  installed, the pair counts are stored through the stand-in of
  ``scripts/torch_h5py_standin.py``.
- surface (slice 12), after the timed paths: the headline's catalogs with
  their tile caches dropped, ``Catalog.build_trees`` on the card (reference
  and randoms with the measurement's largest angle, the unknown sample
  unbinned), then ``crosscorrelate`` + n(z): it builds no tile set, uploads
  no lanes and derives no chunk caps (spies), runs K1.1 and kernel B and no
  plain engine on the card, and its DD and RD counts are the main path's
  bit for bit; the times of ``build_trees``, that measurement, the
  headline's warm median and a cold measurement without ``build_trees``.
  Then ``RandomReader`` over 1M ``HealPixRandoms`` (the survey's mask, nside
  and seed) in chunks of 250k streamed by ``write_patches_streaming`` into a
  cache, patch assignment on the card against the headline's 64 centers:
  with ``keep_data=False`` it returns no data and the cache reads back 1M
  rows; with ``keep_data=True`` it writes the same files byte for byte and
  returns the cache's rows; the host memory each adds is logged;
- survey-scale proofs, at a reduced size, each script in a subprocess on
  the card: ``scripts/torch_survey_proof.py`` at 4M rows (Parquet
  streamed into caches in 2, 4 and 5 reader rounds, 128 kmeans patches,
  blocked ``crosscorrelate(max_resident_patches=24)`` on ``LazyCatalog``,
  the float64 oracle on a stride-16 downsample) and
  ``scripts/torch_tomo_pipeline_proof.py`` at 1M rows (the command line
  over 4 tomographic bins from Parquet, 96 patches, 24 resident, lazy,
  against a stride-8 downsample). Every gate of each script holds, K1.1
  and kernel B launched once per survey block pair, K1.1, K1.2 and kernel
  B in both pipeline runs, and the plain engine never on the card.

Beside the variants' checks it logs, for each variant of kernel A, the
share of candidate pairs in reach of an edge, the share of chunk blocks
the cumulative kernel's skip rule keeps, and the bound of the work these
inputs need beside the every-pair bound; it holds K1.1 (headline DD and
RD) and K1.2 (w_ss DD) with unit weights on their full pair lists bit for
bit against the plain version, it times kernel B on a list shaped like
the wide grid's cross RD against ``index_add_``, and it holds the flag
kernel (K2.1) bit for bit against the plain flag pass on the full headline
DD and RD and w_ss DD lists with the audit's band, logging both times, the
every-pair and reach bounds, the kept share of chunk blocks and the
flagged share of tile pairs.
Every path resets the kernels' launch counts before it runs and checks
after it that each variant of the path launched. The single-device phases
pin the automatic device pool to one card (``YAWT_NUM_DEVICES=1``). The counts are checked
against the float64 scipy oracle, and each path is timed warm. Every
phase raises on failure, so the exit code is non-zero; the last line of
standard output is the JSON result ``{"ok": true, "device": {...}}``.
Without a CUDA card it exits non-zero before printing a result.
``python3 chip_smoke.py --survey-child KIND ROOT OUT`` is the survey path's
child process (``KIND`` ``catalog`` or ``lazy``) and ``--mp-child ROOT``
a process of the two-process phase; neither is run by hand.
``python3 chip_smoke.py --audit-survey`` runs no phase above: it builds
the kernels and measures the audit at survey size (:func:`audit_survey`).
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

# the h5py stand-in and the host-memory and engine spies are shared with the
# survey-scale proof scripts
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
from torch_h5py_standin import ensure_h5py  # noqa: E402
from torch_proof_common import (  # noqa: E402
    MEMORY_KINDS,
    EngineSpy,
    MemorySampler,
    host_memory,
    host_spans,
)
from torch_proof_common import launches as counted_launches  # noqa: E402


NUM_REFERENCE = 200_000
NUM_UNKNOWN = 500_000
NUM_RANDOMS = 1_000_000
NUM_PATCHES = 64
NUM_BINS = 11
SEED = 12345
ZRANGE = dict(zmin=0.15, zmax=1.0, num_bins=NUM_BINS)
CONFIG = dict(rmin=100, rmax=1000, unit="kpc", **ZRANGE)
CONFIG_B = dict(
    rmin=[100, 300, 500], rmax=[300, 500, 1000], unit="kpc", rweight=-1.0,
    resolution=32, **ZRANGE,
)
"""The JAX benchmark's multi-scale separation-weighted configuration
(``bench.py:1016-1020``): 33+ union edges, so ``auto`` counts directly."""
CONFIG_WIDE = dict(
    rmin=[0.05, 0.4], rmax=[0.5, 1.35], unit="rad", rweight=-1.0,
    resolution=24, **ZRANGE,
)
"""The JAX test's wide grid (``tests/test_engine.py:1294``): edges beyond
THETA_POLY_MAX = 1.2 rad take the arcsine index."""
CONFIG_MANY = dict(
    rmin=[100, 120, 150, 180, 220, 260, 300, 350, 400, 450],
    rmax=[1000, 1100, 1200, 1300, 1400, 1500, 1600, 1700, 1800, 2000],
    unit="kpc", rweight=-1.0, resolution=32, **ZRANGE,
)
"""Ten overlapping scales between 100 and 2,000 kpc: 18 interior limits,
so 18 above-entries per bin (more than 16 per side), 20 counting edges
(two launches of kernel A)."""
RTOL = 1e-6
"""Tolerance of the cumulative comparisons: relative 1e-6, with an
absolute floor of 1e-6 times the largest reference value. Kernel and
plain version share the chord arithmetic and differ in the order of
float32 sums."""
DIRECT_RTOL = 1e-5
"""Kernel vs plain version in direct mode: a 1-ulp difference in ``logf``
moves a pair within ~1e-7 of a sub-edge into the neighbouring
sub-interval (the JAX package's own direct-mode tolerance)."""
DIRECT_ORACLE_RTOL = 5e-5
"""Direct-mode per-scale counts against the union-edge float64 oracle,
per scale max|err| / max|oracle| (the JAX package's measurement
tolerance, ``tests/test_engine.py:1234-1236``)."""
SCALAR_ORACLE_RTOL = 1e-5
"""Signed (kappa) counts against the float64 oracle, per-slot max|err| /
max|oracle|: a sum of signed terms loses the relative float32 precision
its cancellation removes."""
WARM_RUNS = 5
KERNEL_REPS = 5
GRAPH_LAUNCHES = 20
PLAIN_CHUNK = 64
"""Tile pairs per batch of the plain engine on the card (64 MiB per
(chunk, 512, 512) float32 temporary)."""
PLAIN_LIMIT = 2048
"""Tile pairs a new variant is held against its plain version on (the
first entries of its path's pair list): the plain direct-mode engine
takes ~1 ms per tile pair."""
MANY_LIMIT = 384
"""Tile pairs of the >16-entry configuration held against the plain
version."""
RR_ORACLE_SLOTS = 48
"""Slots of the 1M-random RR count checked against the oracle."""
F32_RATE = 67e12
"""Float32 operations/s of one H100 SXM outside the tensor cores (NVIDIA
data sheet, at the 700 W power limit)."""
HBM_RATE = 3.35e12
"""Device memory bytes/s of one H100 SXM."""
SURVEY_SIZES = dict(num_reference=1_000_000, num_unknown=2_000_000)
SURVEY_RANDOMS = 4_000_000
SURVEY_PATCHES = 96
SURVEY_RESIDENT = 24
SURVEY_SEED = 777
SURVEY_RANDOM_SEED = 199
SURVEY_NSIDE = 128
SURVEY_NAMES = ("reference", "unknown", "randoms")
SURVEY_ORACLE_SLOTS = 48
SURVEY_WARM_RUNS = 3
SURVEY_PHASES = (
    "rows", "cols", "pairs", "queue", "drain_wait", "drain_fetch",
    "drain_scatter",
)
"""The blocked loop's phases in a survey run's statistics, in seconds from
its spans (``blocked.<phase>``)."""
SURVEY_COUNTERS = {
    "upload": "blocked.upload_s",
    "upload_bytes": "blocked.upload_bytes",
    "store_hits": "cache.hit.store",
    "store_misses": "cache.miss.store",
    "num_block_pairs": "blocked.block_pairs",
    "candidate_pairs": "engine.candidate_pairs",
}
"""A survey run's counters, by the program's counter each reads."""
AUDIT_RTOL = 1e-6
"""Audited counts against the float64 oracle, per slot and element: with
the audit, no pair within float32 resolution of an edge is left in the
wrong bin, so the per-slot relative error is the float32 sums' alone."""
AUDIT_EXACT = 1e-12
"""A flagged slot's audited counts against the oracle (the same float64
recount of the same points)."""
AUDIT_CUT = 2
"""The blocked audit's catalogs: the benchmark's reference and randoms
divided by this factor (100k and 500k points), to keep its two float64
recounts short while slots are still flagged."""
AUDIT_RESIDENT = 16
SURVEY_BUDGET = 64 << 20
"""The binding resident budget of the survey: below the 225.6 MB of lanes
the default budget holds resident."""
SHARDS = 4
"""Shards of the sharded phases: the first four cards, or four entries of
``cuda:0`` on a machine with fewer."""
LAYOUTS = ("replicated", "columns", "ring")
SHARDED_WARM_RUNS = 3
MP_PROCESSES = 2
MP_TIMEOUT = 300
"""Seconds the two-process phase waits for its children."""
CATALOG_NAMES = ("reference", "unknown", "randoms")
SURFACE_RANDOMS = 1_000_000
SURFACE_CHUNK = 250_000
SURFACE_BUFFERSIZE = 2_048
SOURCE = "yet_another_wizz_tpu_torch/csrc/paircount.cu"
REPLACES = "yet_another_wizz_tpu/ops/pallas_paircount.py:58"
FLAGS_REPLACE = "yet_another_wizz_tpu/ops/paircount.py:257"
"""K2.1: ``_pair_block_boundary`` (XLA), which the flag kernel replaces with
``_boundary_flags_xla`` (``:303``) and ``_boundary_flags_gathered``
(``:327``)."""


def log(message: str) -> None:
    print(message, flush=True)


def check(condition: bool, message: str) -> None:
    if not condition:
        raise RuntimeError(message)


def compare(actual, desired, rtol: float = RTOL) -> tuple[float, float]:
    """``(max_abs_err, max_rel_err)`` of two tensors; raises unless they
    agree within ``rtol`` (absolute floor ``rtol * max|desired|``)."""
    actual = actual.double()
    desired = desired.double()
    diff = (actual - desired).abs()
    floor = rtol * desired.abs().max().item()
    within = diff <= rtol * desired.abs() + floor
    big = desired.abs() > floor
    rel = (diff[big] / desired.abs()[big]).max().item() if big.any() else 0.0
    check(bool(within.all()), f"disagreement beyond rtol {rtol}: max rel {rel:.3e}")
    return diff.max().item(), rel


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` on the card, from CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def graph_ms(fn, launches: int = GRAPH_LAUNCHES, reps: int = KERNEL_REPS) -> float:
    """Milliseconds of one ``fn()`` on the card without its host time: the
    median replay of a CUDA graph of ``launches`` calls, over their number.
    For a kernel shorter than the Python call that launches it, a call
    timed alone measures the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return cuda_ms(graph.replay, reps) / launches


def environment() -> str:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: chip_smoke.py needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch.cuda.get_device_name: {torch.cuda.get_device_name(0)}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    from torch.utils.cpp_extension import CUDA_HOME

    check(CUDA_HOME is not None, "no CUDA toolkit found")
    nvcc = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "nvcc"), "--version"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    log(f"nvcc: {nvcc[-1]}")
    return smi


def ptxas_summary(compiler_log: str) -> list[str]:
    """One line per kernel instance: template arguments, registers, the
    blocks of 256 threads per SM those registers allow (65,536 registers
    per SM, allocated in units of 8 per thread; at most 8 blocks) and
    spill bytes, from ``nvcc -Xptxas -v``."""
    lines, name, spill = [], None, ""
    variant = re.compile(
        r"paircount_(?:partials|direct)_kernelILi(\d+)ELb([01])E(?:Li(\d+)E)?"
    )
    evaluate = re.compile(r"flag_evaluate_kernelILi(\d+)ELb([01])E")
    triage = re.compile(r"flag_triage_kernelILb([01])E")
    for line in compiler_log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = entry.group(1)
            match = variant.search(name)
            if match:
                ne, binned, direct = match.groups()
                name = f"A<NE={ne}, binned={binned}, direct={direct or 0}>"
            elif evaluate.search(name):
                ne, binned = evaluate.search(name).groups()
                name = f"C2 flag evaluate<NE={ne}, binned={binned}>"
            elif triage.search(name):
                name = f"C1 flag triage<binned={triage.search(name).group(1)}>"
            elif "flag_reach_kernel" in name:
                name = "C0 flag reach"
            elif "segment_sum" in name:
                name = "B segment_sum"
        stores = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if stores:
            spill = f"spill {stores.group(1)}/{stores.group(2)} B"
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            registers = int(used.group(1))
            blocks = min(8, 65536 // (256 * (-(-registers // 8) * 8)))
            lines.append(f"{name}: {registers} registers ({blocks} blocks/SM), "
                         f"{spill}")
            name = None
    return lines


def build_kernels() -> None:
    from yet_another_wizz_tpu_torch import _native
    from yet_another_wizz_tpu_torch.ops import cuda_paircount

    t0 = time.perf_counter()
    compiler_log = cuda_paircount.build()
    log(f"built CUDA kernels ({len(cuda_paircount.MODES)} nvcc processes in "
        f"parallel) in {time.perf_counter() - t0:.2f} s")
    summary = ptxas_summary(compiler_log)
    for line in summary:
        log(f"  ptxas: {line}")
    spilling = [line for line in summary if "spill 0/0 B" not in line]
    log(f"  ptxas: {len(summary)} kernel instances, {len(spilling)} spill")
    check(not spilling, "kernel instances spill registers")
    for line in summary:
        registers = int(re.search(r": (\d+) registers", line).group(1))
        check(not line.startswith("A<") or "direct=0" in line or registers <= 64,
              f"a direct instance needs more than 64 registers: {line}")
    t0 = time.perf_counter()
    log(f"native host library: {'built' if _native.enabled() else 'MISSING'} "
        f"in {time.perf_counter() - t0:.2f} s")


def make_catalogs():
    """The benchmark's mock catalogs; the reference carries a kappa column
    drawn from the seed (used only by the scalar measurements)."""
    import numpy as np

    from yet_another_wizz_tpu_torch.catalog import Catalog
    from yet_another_wizz_tpu_torch.examples import generate_mock_data

    stages = {}
    t0 = time.perf_counter()
    mock = generate_mock_data(
        num_reference=NUM_REFERENCE, num_unknown=NUM_UNKNOWN,
        num_randoms=NUM_RANDOMS, seed=SEED,
    )
    kappa = np.random.default_rng(SEED).normal(0.1, 0.3, NUM_REFERENCE)
    stages["mock"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reference = Catalog.from_arrays(
        **mock["reference"], kappa=kappa, degrees=False,
        patch_num=NUM_PATCHES,
    )
    centers = reference.get_centers()
    unknown = Catalog.from_arrays(
        **mock["unknown"], degrees=False, patch_centers=centers
    )
    randoms = Catalog.from_arrays(
        **mock["randoms"], degrees=False, patch_centers=centers
    )
    stages["catalogs"] = time.perf_counter() - t0
    return (reference, unknown, randoms), stages


# -- counts of one measurement ----------------------------------------------

COUNTS = {
    # name: (rows, columns (None: auto), binned2, mode); catalog indices
    # 0 reference, 1 unknown, 2 randoms
    "cross DD": (0, 1, False, "nn"),
    "cross RD": (2, 1, False, "nn"),
    "cross DR": (0, 2, False, "nn"),
    "auto DD": (0, None, True, "nn"),
    "auto DR": (0, 2, True, "nn"),
    "auto RR": (2, None, True, "nn"),
    "scalar kn DD": (0, 1, False, "kn"),
    "scalar kn DR": (0, 2, False, "kn"),
    "scalar kk DD": (0, None, True, "kk"),
}


def engine_inputs(links, catalogs, count):
    rows, cols, binned2, mode = COUNTS[count]
    auto = cols is None
    return links._build_engine_inputs(
        catalogs[rows], catalogs[rows if auto else cols], auto=auto,
        binned2=binned2, mode=mode,
    )


def ops_per_pair(table_width: int, direct: tuple | None) -> int:
    """float32 operations per candidate pair (``BASELINE.md:40-53``): 15 for
    the compensated chord, 1 for the column weight, 3 per counting edge;
    direct mode adds 12 (small-angle) or 18 (arcsine) and 3 per
    adjustment entry: the every-pair bound, as if every pair were
    weighted."""
    from yet_another_wizz_tpu_torch.ops.gweight import counting_width

    ops = 16 + 3 * counting_width(table_width, direct)
    if direct is not None:
        ops += weight_ops(direct) + 3 * (direct[1] + direct[2])
    return ops


def weight_ops(direct: tuple) -> int:
    """float32 operations of one pair's separation weight: 12 with the
    small-angle index, 18 with the arcsine index."""
    return 12 if direct[3] else 18


def bound(operations: float, num_bytes: float) -> tuple[float, str]:
    """The least milliseconds the card could take, and what bounds it."""
    t_ops = operations / F32_RATE
    t_bytes = num_bytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def reaching_pairs(lanes1, lanes2, tile1, tile2, table, direct, cols_binned):
    """What the inputs of a kernel-A variant need, counted by the plain
    engine with unit weights (1 where a weight is nonzero: padding stays 0)
    against tables of the rows' largest thresholds: for each launch, the
    pairs within the largest threshold of its edge group (and, with binned
    columns, of equal bins), and the pairs within the largest threshold of
    any edge. Also the share of the first launch's (warp, column) steps in
    which any of the warp's 32 consecutive rows reaches the column, and,
    per launch, the share of (row chunk, column chunk) blocks that the
    cumulative kernel's skip rule keeps (``chunk_keep_mask``, on the
    card). Returns ``(per_launch, group_sizes, any_edge, warp_share,
    kept_shares)``."""
    import torch

    from yet_another_wizz_tpu_torch.ops import cuda_paircount
    from yet_another_wizz_tpu_torch.ops.gweight import counting_width
    from yet_another_wizz_tpu_torch.ops.paircount import (
        chunk_keep_mask,
        partial_counts_torch,
    )
    from yet_another_wizz_tpu_torch.ops.tiles import chunk_caps

    num_edges = counting_width(table.shape[1], direct)
    group = cuda_paircount.MAX_EDGES_PER_LAUNCH
    starts = range(0, num_edges, group)
    sizes = [min(group, num_edges - e0) for e0 in starts]
    reach = torch.stack([
        table[:, e0:e0 + size].max(dim=1).values
        for e0, size in zip(starts, sizes)
    ] + [table[:, :num_edges].max(dim=1).values], dim=1)  # (B, launches + 1)
    ones1, ones2 = unit_weights(lanes1), unit_weights(lanes2)
    counts = partial_counts_torch(
        ones1, ones2, tile1.long(), tile2.long(), reach,
        cols_binned=cols_binned, chunk_size=PLAIN_CHUNK,
    ).double().sum(dim=(0, 1)).tolist()
    steps = hits = 0
    for start in range(0, len(tile1), PLAIN_CHUNK):
        rows = lanes1[tile1[start:start + PLAIN_CHUNK].long()]
        cols = lanes2[tile2[start:start + PLAIN_CHUNK].long()]
        chord2 = 0.0
        for d in range(3):  # the kernel's compensated chord
            diff = (rows[:, d, :, None] - cols[:, None, d, :]) + (
                rows[:, 3 + d, :, None] - cols[:, None, 3 + d, :]
            )
            chord2 = chord2 + diff * diff
        bins = rows[:, 7].long().clamp(0, table.shape[0] - 1)
        reached = chord2 <= reach[bins, 0][:, :, None]
        reached &= (rows[:, 6] != 0)[:, :, None] & (cols[:, 6] != 0)[:, None, :]
        if cols_binned:
            reached &= rows[:, 7, :, None] == cols[:, None, 7, :]
        num, size = reached.shape[:2]
        hits += reached.view(num, size // 32, 32, size).any(dim=2).sum().item()
        steps += num * (size // 32) * size
    caps1, caps2 = chunk_caps(lanes1), chunk_caps(lanes2)
    kept = [
        chunk_keep_mask(
            lanes1, caps1, caps2, tile1, tile2, table[:, e0:e0 + size],
            cols_binned=cols_binned,
        ).double().mean().item()
        for e0, size in zip(starts, sizes)
    ]
    return counts[:-1], sizes, counts[-1], hits / steps, kept


def unit_weights(lanes):
    """The lanes with weight 1 wherever it is nonzero (padding stays 0)."""
    lanes = lanes.clone()
    lanes[:, 6] = (lanes[:, 6] != 0).to(lanes.dtype)
    return lanes


def reach_operations(per_launch, sizes, any_edge, direct, cols_binned) -> float:
    """float32 operations these inputs need, for every kernel-A variant:
    the chord and the compare against the row's reach (16, +1 bin compare
    when binned) for each pair in reach of its row's largest threshold (of
    an equal bin, when binned); 3 per counting edge of a launch for each
    pair in that launch's reach; in direct mode the separation weight and
    its product with the column weight once for each pair in reach of any
    edge. The entries a weighted pair walks are left out (most
    sub-intervals have none), so it stays a lower bound."""
    ops = any_edge * (16 + int(cols_binned))
    ops += sum(3 * size * pairs for size, pairs in zip(sizes, per_launch))
    if direct is not None:
        ops += any_edge * (1 + weight_ops(direct))
    return ops


def variant_check(card, links, catalogs, count, *, limit: int | None) -> dict:
    """A kernel-A variant against its plain version on the inputs of one
    count of its path (the first ``limit`` entries of the pair list): two
    kernel runs bitwise equal, the error, the kernel's and the plain
    version's milliseconds, and the bound of the work these inputs need
    (:func:`reach_operations`: the ``bound_ms`` of the result) beside the
    every-pair bound, with the shares of candidate pairs in reach and of
    chunk blocks the cumulative skip rule keeps."""
    import torch

    from yet_another_wizz_tpu_torch.ops import cuda_paircount
    from yet_another_wizz_tpu_torch.ops.paircount import partial_counts_torch

    tiles1, tiles2, pairs = engine_inputs(links, catalogs, count)
    table_np, _, direct, _ = links.engine_table()
    device = torch.device("cuda")
    lanes1 = tiles1.device_data(device)
    lanes2 = tiles2.device_data(device)
    table = torch.from_numpy(table_np).to(device)
    k = slice(0, limit)
    tile1 = torch.from_numpy(pairs.tile1[k]).to(device)
    tile2 = torch.from_numpy(pairs.tile2[k]).to(device)
    kwargs = dict(cols_binned=tiles2.binned, direct=direct)
    name = cuda_paircount.variant_name(tiles2.binned, direct)

    def kernel():
        return cuda_paircount.paircount_partials(
            lanes1, lanes2, tile1, tile2, table, **kwargs
        )

    def plain():
        return partial_counts_torch(
            lanes1, lanes2, tile1.long(), tile2.long(), table,
            chunk_size=PLAIN_CHUNK, **kwargs,
        )

    first, second = kernel(), kernel()
    torch.cuda.synchronize()
    check(torch.equal(first, second), f"{name} is not deterministic")
    expected = plain()
    torch.cuda.synchronize()
    err = compare(first, expected, RTOL if direct is None else DIRECT_RTOL)
    num_pairs = len(tile1)
    candidates = num_pairs * tiles1.tile_size ** 2
    num_bytes = nbytes(lanes1, lanes2, tile1, tile2, table, first)
    every_pair_ms, _ = bound(
        candidates * ops_per_pair(table.shape[1], direct), num_bytes
    )
    per_launch, sizes, any_edge, warp_share, kept = reaching_pairs(
        lanes1, lanes2, tile1, tile2, table, direct, tiles2.binned
    )
    bound_ms, bound_by = bound(
        reach_operations(per_launch, sizes, any_edge, direct, tiles2.binned),
        num_bytes,
    )
    shares = " + ".join(f"{n / candidates:.4f}" for n in per_launch)
    result = dict(
        name=name, count=count, tile_pairs=num_pairs, err=err,
        ms=cuda_ms(kernel, KERNEL_REPS), plain_ms=cuda_ms(plain, 1),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        negative=bool((lanes1[tile1.long(), 6] < 0).any()),
    )
    log(f"[{card}] {name} [{count}, {num_pairs} of {pairs.num_pairs} tile pairs, "
        f"table {tuple(table.shape)}, direct {direct}]: kernel "
        f"{result['ms']:.3f} ms, plain {result['plain_ms']:.3f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}), every-pair bound {every_pair_ms:.3f} "
        f"ms, pairs in reach of an edge {any_edge / candidates:.4f} (of each "
        f"launch's edges {shares}; warp steps {warp_share:.4f}), chunk blocks "
        f"kept {' + '.join(f'{x:.4f}' for x in kept)}, max abs err "
        f"{err[0]:.3e}, max rel err {err[1]:.3e}, two kernel runs bitwise equal")
    return result


def unit_weight_check(card, links, catalogs, count) -> None:
    """K1.1 / K1.2 on the full pair list of one count with unit weights (1
    where a weight is nonzero, padding stays 0; the wrapper derives the
    chunk caps from those lanes): integer counts below 2^24 are exact in any order, so the kernel
    must be ``torch.equal`` to the plain version, and a wrongly skipped
    pair would show."""
    import torch

    from yet_another_wizz_tpu_torch.ops import cuda_paircount
    from yet_another_wizz_tpu_torch.ops.paircount import partial_counts_torch

    tiles1, tiles2, pairs = engine_inputs(links, catalogs, count)
    table, _, direct, _ = links.engine_table()
    check(direct is None, f"{count} does not count cumulatively")
    device = torch.device("cuda")
    lanes1 = unit_weights(tiles1.device_data(device))
    lanes2 = unit_weights(tiles2.device_data(device))
    table = torch.from_numpy(table).to(device)
    tile1 = torch.from_numpy(pairs.tile1).to(device)
    tile2 = torch.from_numpy(pairs.tile2).to(device)
    kernel = cuda_paircount.paircount_partials(
        lanes1, lanes2, tile1, tile2, table, cols_binned=tiles2.binned
    )
    plain = partial_counts_torch(
        lanes1, lanes2, tile1.long(), tile2.long(), table,
        cols_binned=tiles2.binned, chunk_size=PLAIN_CHUNK,
    )
    torch.cuda.synchronize()
    name = cuda_paircount.variant_name(tiles2.binned, None)
    check(torch.equal(kernel, plain),
          f"{name} [{count}] with unit weights differs from the plain version "
          f"(max abs {(kernel - plain).abs().max().item():.3e})")
    log(f"[{card}] {name} [{count}, all {pairs.num_pairs} tile pairs, unit "
        f"weights]: torch.equal to the plain version ({plain.sum().item():.6e} "
        "pairs counted)")


def segment_check(card, label, partial, pairs, *, double_reference=False):
    """Kernel B against its plain version (in float64 with
    ``double_reference``) and ``index_add_`` on the partials of one list:
    two kernel runs bitwise equal, the error, the bound, and the times on
    the card from CUDA graphs (kernel, plain version and ``index_add_``
    alike), beside each call's time with its host work."""
    import numpy as np
    import torch

    from yet_another_wizz_tpu_torch.ops import cuda_paircount
    from yet_another_wizz_tpu_torch.ops.paircount import segment_sum_torch

    device = partial.device
    slot = torch.from_numpy(pairs.slot.astype(np.int64)).to(device)
    offsets = torch.from_numpy(
        np.searchsorted(pairs.slot, np.arange(pairs.num_slots + 1))
    ).to(device)

    def seg():
        return cuda_paircount.segment_sum(partial, slot, offsets, pairs.num_slots)

    def plain_seg():
        return segment_sum_torch(partial, slot, pairs.num_slots)

    zeros = torch.zeros((pairs.num_slots, *partial.shape[1:]), device=device)

    def library_seg():
        return zeros.index_add_(0, slot, partial)

    out, out2 = seg(), seg()
    torch.cuda.synchronize()
    check(torch.equal(out, out2), "segment_sum is not deterministic")
    if double_reference:
        err = compare(out, segment_sum_torch(partial.double(), slot, pairs.num_slots))
    else:
        err = compare(out, plain_seg())
    bound_ms, bound_by = bound(partial.numel(), nbytes(partial, offsets, out))
    result = dict(
        name="paircount_segment_sum", count=label,
        tile_pairs=pairs.num_pairs, err=err, ms=graph_ms(seg),
        plain_ms=graph_ms(plain_seg), bound_ms=bound_ms,
        bound_by=bound_by, library_ms=graph_ms(library_seg),
    )
    log(f"[{card}] paircount_segment_sum [{label}, {pairs.num_pairs} entries in "
        f"{pairs.num_slots} slots, {nbytes(partial) / 1e6:.1f} MB]: kernel "
        f"{result['ms']:.4f} ms, plain {result['plain_ms']:.4f} ms, index_add_ "
        f"{result['library_ms']:.4f} ms (CUDA graphs of {GRAPH_LAUNCHES}; one "
        f"call with its host work: kernel {cuda_ms(seg, KERNEL_REPS):.4f} ms, "
        f"index_add_ {cuda_ms(library_seg, KERNEL_REPS):.4f} ms), bound "
        f"{bound_ms:.4f} ms ({bound_by}), max abs err {err[0]:.3e}"
        f"{' (against float64)' if double_reference else ''}, two kernel runs "
        "bitwise equal")
    return result


def flag_check(card, links, catalogs, count) -> dict:
    """The flag kernel (K2.1) against the plain flag pass on the full pair
    list of one count, with the audit's band (``audit_band`` of the union
    edges): bit for bit, two kernel runs equal; the pass's milliseconds
    (its three launches, median of :data:`KERNEL_REPS`) and the plain
    version's (one run); the every-pair bound (every candidate pair at 16
    + 3E float32 operations) and the reach bound (the ``bound_ms`` of the
    result: 16 + 3E operations for each valid pair within its row's
    widened reach, the largest ``t + band`` of its bin, in the tile pairs
    the kernel does not flag, and one pair for each it flags); the share
    of chunk blocks the widened skip keeps (``chunk_keep_mask`` with the
    band), the work items and the tile pairs triaged to 0, and of tile
    pairs flagged. Its first two launches alone, the reach (C0) and the
    triage (C1), equal their plain mirrors on the CPU (``chunk_reach``
    bitwise, ``flag_work_items`` as a set of items) and are timed in CUDA
    graphs. Returns the results of the three, by launch-count key."""
    import numpy as np
    import torch

    from yet_another_wizz_tpu_torch.ops import cuda_paircount
    from yet_another_wizz_tpu_torch.ops.paircount import (
        audit_band,
        boundary_flags,
        boundary_flags_torch,
        chunk_reach,
        flag_work_items,
        partial_counts_torch,
    )
    from yet_another_wizz_tpu_torch.ops.tiles import chunk_caps

    tiles1, tiles2, pairs = engine_inputs(links, catalogs, count)
    device = torch.device("cuda")
    table_np = np.ascontiguousarray(links.edges.chord2_table, np.float32)
    band_np = audit_band(links.edges.edges, table_np).astype(np.float32)
    table = torch.from_numpy(table_np).to(device)
    band = torch.from_numpy(band_np).to(device)
    lanes1 = tiles1.device_data(device)
    lanes2 = tiles2.device_data(device)
    tile1 = torch.from_numpy(pairs.tile1.astype(np.int32)).to(device)
    tile2 = torch.from_numpy(pairs.tile2.astype(np.int32)).to(device)
    cols_binned = tiles2.binned

    def kernel():
        return boundary_flags(
            lanes1, lanes2, tile1, tile2, table, band, cols_binned=cols_binned
        )

    def plain():
        return boundary_flags_torch(
            lanes1, lanes2, tile1.long(), tile2.long(), table, band,
            cols_binned=cols_binned,
        )

    first, second = kernel(), kernel()
    torch.cuda.synchronize()
    check(torch.equal(first, second), "boundary_flags is not deterministic")
    expected = plain()
    torch.cuda.synchronize()
    check(torch.equal(first, expected),
          f"boundary_flags [{count}] differs from the plain flag pass in "
          f"{int((first != expected).sum())} of {len(first)} tile pairs")
    num_pairs = len(tile1)
    per_pair = 16 + 3 * table.shape[1]
    candidates = num_pairs * tiles1.tile_size * tiles2.tile_size
    num_bytes = nbytes(lanes1, lanes2, tile1, tile2, table, band, first)
    every_pair_ms, _ = bound(candidates * per_pair, num_bytes)
    reach = (table + band).amax(dim=1, keepdim=True)
    in_reach = partial_counts_torch(
        unit_weights(lanes1), unit_weights(lanes2), tile1.long(), tile2.long(),
        reach, cols_binned=cols_binned, chunk_size=PLAIN_CHUNK,
    ).double().sum(dim=(1, 2))
    needed = in_reach[~first].sum().item() + first.sum().item()
    bound_ms, bound_by = bound(needed * per_pair, num_bytes)

    # C0 and C1 alone against their mirrors on the CPU (the first group of
    # 16 edges: the table has fewer)
    check(table.shape[1] <= cuda_paircount.MAX_EDGES_PER_LAUNCH,
          f"{count}: more than one group of edges")
    host = [t.cpu() for t in (lanes1, lanes2, tile1, tile2, table, band)]
    caps1, caps2 = chunk_caps(host[0]), chunk_caps(host[1])
    row_reach = cuda_paircount.flag_reach_cuda(lanes1, table, band)
    check(torch.equal(row_reach.cpu(), chunk_reach(host[0], caps1, *host[4:])),
          f"flag reach [{count}] differs from chunk_reach")
    items, length = cuda_paircount.flag_triage_cuda(
        lanes1, lanes2, tile1, tile2, row_reach, cols_binned=cols_binned
    )
    work = cuda_paircount.decode_work_items(items, length)
    check(torch.equal(work, flag_work_items(
        host[0], caps1, caps2, *host[2:], cols_binned=cols_binned)),
        f"flag triage [{count}] differs from flag_work_items")
    num_chunks = tiles1.tile_size // 32
    kept = sum(bin(mask).count("1") for mask in work[:, 2].tolist())
    kept_share = kept / (num_pairs * num_chunks**2)
    idle = num_pairs - len(torch.unique(work[:, 0]))
    ms = cuda_ms(kernel, KERNEL_REPS)
    reach_ms = graph_ms(
        lambda: cuda_paircount.flag_reach_cuda(lanes1, table, band)
    )
    triage_ms = graph_ms(lambda: cuda_paircount.flag_triage_cuda(
        lanes1, lanes2, tile1, tile2, row_reach, cols_binned=cols_binned
    ))
    caps_dev = cuda_paircount._device_caps(lanes1), cuda_paircount._device_caps(lanes2)
    # C0 reads two lanes of every row and a radius per chunk, writes a reach
    # per chunk; C1 reads both tile sets' caps, the reach and the tile
    # indices once and writes its items, 12 float32 operations per chunk
    # block (13 with binned columns: the bin ranges)
    reach_bytes = (lanes1.numel() // 4 + 2 * row_reach.numel()) * 4 + nbytes(table, band)
    reach_bound = bound(lanes1.shape[0] * tiles1.tile_size * 2 * table.shape[1],
                        reach_bytes)
    triage_bound = bound(
        num_pairs * num_chunks**2 * (13 if cols_binned else 12),
        nbytes(*caps_dev, row_reach, tile1, tile2) + 8 * len(work),
    )
    plain_reach_ms = cuda_ms(lambda: chunk_reach(lanes1, caps_dev[0], table, band), 1)
    plain_triage_ms = cuda_ms(lambda: flag_work_items(
        lanes1, *caps_dev, tile1, tile2, table, band, cols_binned=cols_binned
    ), 1)
    result = dict(
        name="boundary_flags", count=count, tile_pairs=num_pairs,
        err=(0.0, 0.0), ms=ms, plain_ms=cuda_ms(plain, 1), bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None, replaces=FLAGS_REPLACE,
    )
    log(f"[{card}] boundary_flags [{count}, all {num_pairs} tile pairs, table "
        f"{tuple(table.shape)}, binned columns {cols_binned}]: kernel "
        f"{ms:.4f} ms (reach + triage + evaluation), plain "
        f"{result['plain_ms']:.1f} ms, reach "
        f"bound {bound_ms:.4f} ms ({bound_by}; pairs in the widened reach "
        f"{in_reach.sum().item() / candidates:.4f} of the candidates, "
        f"{needed / candidates:.4f} needed), every-pair bound "
        f"{every_pair_ms:.3f} ms, chunk blocks kept {kept_share:.4f} (reach "
        f"rule), work items {len(work)} ({len(work) / num_pairs:.2f} per tile "
        f"pair), tile pairs triaged to 0 {idle} ({idle / num_pairs:.4f}), tile "
        f"pairs flagged {int(first.sum())} ({first.double().mean().item():.4f}), "
        "bit for bit the plain flag pass, two kernel runs equal")
    log(f"[{card}] flag reach (C0) [{count}, {row_reach.numel()} row chunks]: "
        f"{reach_ms:.4f} ms (CUDA graphs), plain {plain_reach_ms:.3f} ms, bound "
        f"{reach_bound[0]:.5f} ms ({reach_bound[1]}), bitwise chunk_reach; "
        f"flag triage (C1): {triage_ms:.4f} ms (with its counters' zeroing), "
        f"plain {plain_triage_ms:.2f} ms, bound {triage_bound[0]:.5f} ms "
        f"({triage_bound[1]}), the items of flag_work_items")
    common = dict(count=count, err=(0.0, 0.0), library_ms=None,
                  replaces=FLAGS_REPLACE)
    return {
        "boundary_flags": result,
        "boundary_flags_reach": dict(
            common, name="boundary_flags_reach", ms=reach_ms,
            plain_ms=plain_reach_ms, bound_ms=reach_bound[0],
            bound_by=reach_bound[1],
        ),
        "boundary_flags_triage": dict(
            common, name="boundary_flags_triage", ms=triage_ms,
            plain_ms=plain_triage_ms, bound_ms=triage_bound[0],
            bound_by=triage_bound[1],
        ),
    }


def kernels_vs_plain(card, catalogs, configs) -> dict:
    """Every kernel against its plain version on the card, on the real
    inputs of its path; the direct kernel also on the >16-entry
    configuration."""
    import torch

    from yet_another_wizz_tpu_torch.correlation.measurements import PatchLinkage
    from yet_another_wizz_tpu_torch.ops import cuda_paircount

    links = {
        name: PatchLinkage.from_catalogs(config, *catalogs)
        for name, config in configs.items()
    }
    results = {}
    # K1.1 on the full headline DD list, and kernel B on its partials
    results["paircount_partials"] = variant_check(
        card, links["headline"], catalogs, "cross DD", limit=None
    )
    # K1.1 (headline DD, RD) and K1.2 (w_ss DD) on their full lists with
    # unit weights: bit for bit the plain version
    for count in ("cross DD", "cross RD", "auto DD"):
        unit_weight_check(card, links["headline"], catalogs, count)
    tiles1, tiles2, pairs = engine_inputs(links["headline"], catalogs, "cross DD")
    device = torch.device("cuda")
    partial = cuda_paircount.paircount_partials(
        tiles1.device_data(device), tiles2.device_data(device),
        torch.from_numpy(pairs.tile1).to(device),
        torch.from_numpy(pairs.tile2).to(device),
        torch.from_numpy(links["headline"].edges.chord2_table).to(device),
    )
    results["paircount_segment_sum"] = segment_check(
        card, "cross DD", partial, pairs
    )
    # kernel B on a list shaped like the wide grid's cross RD (its slot
    # runs, values from the seed: the kernel's time does not depend on
    # them), against the plain version in float64: over runs this long two
    # float32 summation orders differ by more than RTOL
    _, _, rd_pairs = engine_inputs(links["wide"], catalogs, "cross RD")
    gen = torch.Generator(device=device).manual_seed(SEED)
    partial = torch.rand(
        (rd_pairs.num_pairs, NUM_BINS, links["wide"].edges.num_counting_edges),
        generator=gen, device=device,
    )
    segment_check(card, "wide-grid cross RD shape", partial, rd_pairs,
                  double_reference=True)
    del partial

    for key, config, count in (
        ("paircount_partials_binned", "headline", "auto DD"),
        ("paircount_partials_direct", "B", "cross DD"),
        ("paircount_partials_direct_binned", "B", "auto DD"),
        ("paircount_partials_arcsine", "wide", "cross DD"),
        ("paircount_partials_arcsine_binned", "wide", "auto DD"),
        ("paircount_partials_signed", "headline", "scalar kn DD"),
        ("paircount_partials_binned_signed", "headline", "scalar kk DD"),
    ):
        result = variant_check(
            card, links[config], catalogs, count, limit=PLAIN_LIMIT
        )
        expected = key.removesuffix("_signed")
        check(result["name"] == expected, f"{count} ran {result['name']}")
        if key.endswith("_signed"):
            check(result["negative"], f"{count} has no negative weights")
            result["name"] = key
        results[key] = result
    # more than 16 below- or above-entries per bin: the same variant, held
    # against its plain version
    direct = links["many"].edges.direct
    check(max(direct.num_below, direct.num_above) > 16,
          f"the many-scale configuration has {direct.num_below} below- and "
          f"{direct.num_above} above-entries")
    result = variant_check(
        card, links["many"], catalogs, "cross DD", limit=MANY_LIMIT
    )
    check(result["name"] == "paircount_partials_direct",
          f"the many-scale cross DD ran {result['name']}")
    # the flag kernel (K2.1) on the headline's DD and RD and w_ss DD lists
    results.update(flag_check(card, links["headline"], catalogs, "cross DD"))
    for count in ("cross RD", "auto DD"):
        flag_check(card, links["headline"], catalogs, count)
    return results


# -- float64 oracle -----------------------------------------------------------


def oracle_counts(links, catalogs, count, slots=None):
    """The engine's per-slot cumulative counts of one count (on the card)
    and the float64 oracle's, on the union-edge table, for all slots or
    the given slot indices."""
    import numpy as np

    from yet_another_wizz_tpu_torch.ops.cpu_oracle import (
        count_pairs_oracle_multiprocess,
    )
    from yet_another_wizz_tpu_torch.ops.paircount import (
        _unpack_tileset,
        count_pairs_tiles,
    )

    tiles1, tiles2, pairs = engine_inputs(links, catalogs, count)
    xyz1, w1, z1, p1 = _unpack_tileset(tiles1)
    xyz2, w2, z2, p2 = _unpack_tileset(tiles2)
    slot_patches = pairs.slot_patches if slots is None else pairs.slot_patches[slots]
    t0 = time.perf_counter()
    oracle = count_pairs_oracle_multiprocess(
        xyz1, w1, z1, p1, xyz2, w2, z2 if tiles2.binned else None, p2,
        slot_patches, links.edges.edges,
        max_workers=len(os.sched_getaffinity(0)),
    )
    seconds = time.perf_counter() - t0
    table, _, direct, mapper = links.engine_table()
    engine = count_pairs_tiles(
        tiles1, tiles2, pairs, table, device="cuda", direct=direct
    )
    if slots is not None:
        engine = engine[slots]
    if direct is not None:  # compare per-scale counts
        return mapper.counts_to_scales(engine), links.edges.counts_to_scales(
            oracle
        ), pairs, seconds
    return engine, oracle, pairs, seconds


def oracle_check(catalogs, config, wsp) -> dict:
    """DD and RD against the float64 scipy oracle: the per-slot cumulative
    counts of the engine, the main path's per-patch-pair counts, and the
    per-bin totals (the JAX package's benchmark metric). Returns the
    oracle's cumulative counts and the pair list of each, by name."""
    import numpy as np

    from yet_another_wizz_tpu_torch.correlation.measurements import PatchLinkage

    links = PatchLinkage.from_catalogs(config, *catalogs)
    oracles = {}
    for name, count, counts in (
        ("DD", "cross DD", wsp.dd), ("RD", "cross RD", wsp.rd)
    ):
        engine, oracle, pairs, t_oracle = oracle_counts(links, catalogs, count)
        scale = np.abs(oracle).max()
        slot_err = np.abs(engine - oracle).max() / scale
        nonzero = oracle != 0
        slot_rel = (np.abs(engine - oracle)[nonzero] / np.abs(oracle[nonzero])).max()

        oracle_scales = links.edges.counts_to_scales(oracle)  # (S, slots, B)
        p_1, p_2 = pairs.slot_patches[:, 0], pairs.slot_patches[:, 1]
        main_path = counts.counts.counts[:, p_1, p_2].T  # (slots, B)
        path_err = np.abs(main_path - oracle_scales[0]).max() / np.abs(
            oracle_scales[0]
        ).max()

        totals_e = links.edges.counts_to_scales(engine).sum(axis=1)
        totals_o = oracle_scales.sum(axis=1)
        total_rel = (np.abs(totals_e - totals_o) / np.abs(totals_o))[
            totals_o > 0
        ].max()
        log(f"{name} vs float64 oracle ({t_oracle:.1f} s): "
            f"per-slot max|err|/max|oracle| {slot_err:.3e}, main-path "
            f"patch-pair counts {path_err:.3e}, per-bin totals max rel "
            f"{total_rel:.3e} (per-slot max rel {slot_rel:.3e}, not gated: a "
            "pair within float32 resolution of an edge moves one pair weight)")
        check(slot_err <= RTOL, f"{name} per-slot counts off the oracle")
        check(path_err <= RTOL, f"{name} main-path counts off the oracle")
        check(total_rel <= RTOL, f"{name} per-bin totals off the oracle")
        oracles[name] = (oracle, pairs)
    return oracles


def main_path_counts(corr, pairs, auto: bool):
    """Per-slot counts ``(slots, B)`` of a measured count, undoing the
    autocorrelation's halving of same-patch slots."""
    p_1, p_2 = pairs.slot_patches[:, 0], pairs.slot_patches[:, 1]
    values = corr.counts.counts[:, p_1, p_2].T.copy()
    if auto:
        values[p_1 == p_2] *= 2.0
    return values


def wss_oracle_check(catalogs, config, wss) -> None:
    """w_ss DD and DR (binned columns) against the float64 oracle on every
    slot, RR on a subset of slots."""
    import numpy as np

    from yet_another_wizz_tpu_torch.correlation.measurements import PatchLinkage

    links = PatchLinkage.from_catalogs(config, catalogs[0], catalogs[2])
    for name, count, counts in (
        ("DD", "auto DD", wss.dd), ("DR", "auto DR", wss.dr),
        ("RR", "auto RR", wss.rr),
    ):
        _, _, pairs = engine_inputs(links, catalogs, count)
        slots = None
        if name == "RR":
            slots = np.linspace(0, pairs.num_slots - 1, RR_ORACLE_SLOTS).astype(int)
        engine, oracle, pairs, t_oracle = oracle_counts(
            links, catalogs, count, slots
        )
        slot_err = np.abs(engine - oracle).max() / np.abs(oracle).max()
        main_path = main_path_counts(counts, pairs, COUNTS[count][1] is None)
        if slots is not None:
            main_path = main_path[slots]
        oracle_scale = links.edges.counts_to_scales(oracle)[0]
        path_err = np.abs(main_path - oracle_scale).max() / np.abs(
            oracle_scale
        ).max()
        log(f"w_ss {name} vs float64 oracle ({len(oracle)} slots, "
            f"{t_oracle:.1f} s): per-slot max|err|/max|oracle| {slot_err:.3e}, "
            f"main-path patch-pair counts {path_err:.3e}")
        check(slot_err <= RTOL, f"w_ss {name} per-slot counts off the oracle")
        check(path_err <= RTOL, f"w_ss {name} main-path counts off the oracle")


def direct_oracle_check(catalogs, config, wsp_scales, wss_scales) -> None:
    """Config B per-scale DD counts (direct mode on the card) against the
    union-edge cumulative float64 oracle."""
    import numpy as np

    from yet_another_wizz_tpu_torch.correlation.measurements import PatchLinkage

    links = PatchLinkage.from_catalogs(config, *catalogs)
    check(links.edges.direct is not None, "config B does not count directly")
    for name, count, scales in (
        ("crosscorrelate DD", "cross DD", wsp_scales),
        ("autocorrelate DD", "auto DD", wss_scales),
    ):
        engine, oracle, pairs, t_oracle = oracle_counts(links, catalogs, count)
        errs = []
        for s, corr in enumerate(scales):
            norm = np.abs(oracle[s]).max()
            main_path = main_path_counts(corr.dd, pairs, COUNTS[count][1] is None)
            errs.append(max(
                np.abs(engine[s] - oracle[s]).max() / norm,
                np.abs(main_path - oracle[s]).max() / norm,
            ))
        log(f"config B {name} vs union-edge float64 oracle ({t_oracle:.1f} s): "
            "per-scale max|err|/max|oracle| "
            + ", ".join(f"{e:.3e}" for e in errs))
        check(max(errs) <= DIRECT_ORACLE_RTOL, f"config B {name} off the oracle")


def scalar_oracle_check(catalogs, config, kn, kk) -> None:
    """The signed kappa counts of the scalar path against the oracle
    backend (float64 kd-trees on the kappa-weighted tiles)."""
    import numpy as np

    from yet_another_wizz_tpu_torch.correlation.measurements import PatchLinkage

    reference, unknown, _ = catalogs
    for name, links, args, mode, corr in (
        ("kn DD", PatchLinkage.from_catalogs(config, *catalogs), (reference, unknown), "kn", kn),
        ("kk DD", PatchLinkage.from_catalogs(config, reference), (reference,), "kk", kk),
    ):
        t0 = time.perf_counter()
        (oracle,) = links.count_pairs(*args, mode=mode, backend="oracle")
        seconds = time.perf_counter() - t0
        expected = oracle.counts.counts
        actual = corr.dd._counts.counts
        err = np.abs(actual - expected).max() / np.abs(expected).max()
        log(f"scalar {name} vs float64 oracle ({seconds:.1f} s): patch-pair "
            f"max|err|/max|oracle| {err:.3e}, negative counts "
            f"{int(np.sum(expected < 0))}")
        check(err <= SCALAR_ORACLE_RTOL, f"scalar {name} off the oracle")


# -- exactness audit ------------------------------------------------------------


def slot_relative_error(actual, desired) -> float:
    """Largest ``|actual - desired| / |desired|`` over the elements where
    ``desired`` is nonzero (0 where there is none)."""
    import numpy as np

    nonzero = desired != 0
    if not nonzero.any():
        return 0.0
    return float((np.abs(actual - desired)[nonzero] / np.abs(desired[nonzero])).max())


@contextlib.contextmanager
def flag_spy():
    """Counts the plain flag pass's calls on CUDA tensors while active (a
    list of one count): on the card the audit must take the kernel."""
    from yet_another_wizz_tpu_torch.ops import paircount

    plain = paircount.boundary_flags_torch
    calls = [0]

    def spy(lanes1, *args, **kwargs):
        calls[0] += lanes1.device.type == "cuda"
        return plain(lanes1, *args, **kwargs)

    paircount.boundary_flags_torch = spy
    try:
        yield calls
    finally:
        paircount.boundary_flags_torch = plain


@contextlib.contextmanager
def plain_flag_pass():
    """The audit's flag pass through its plain version on the card, for a
    rerun whose flagged slots the kernel's must equal."""
    from yet_another_wizz_tpu_torch.ops import paircount

    dispatch = paircount.boundary_flags

    def plain(lanes1, lanes2, tile1, tile2, *args, **kwargs):
        return paircount.boundary_flags_torch(
            lanes1, lanes2, tile1.long(), tile2.long(), *args, **kwargs
        )

    paircount.boundary_flags = plain
    try:
        yield
    finally:
        paircount.boundary_flags = dispatch


def same_flagged_slots(stats, other) -> bool:
    """Whether two lists of audit records flagged the same slots."""
    import numpy as np

    return len(stats) == len(other) and all(
        np.array_equal(a["flagged_slots"], b["flagged_slots"])
        for a, b in zip(stats, other)
    )


def flag_pass_bound(tile_pairs: int, num_edges: int, tile_size: int) -> tuple[float, str]:
    """The least milliseconds of one flag pass (K2.1) over ``tile_pairs``:
    every candidate pair of its list at 16 + 3E float32 operations (the
    compensated chord, the validity test, and a subtraction, absolute value
    and compare per edge), against its bytes (the tile pairs' lanes read
    once, one flag written)."""
    candidates = tile_pairs * tile_size**2
    lanes = 2 * tile_pairs * 8 * tile_size * 4
    return bound(candidates * (16 + 3 * num_edges), lanes + tile_pairs)


def audit_checks(card, catalogs, config, wsp, oracles, launches_total) -> None:
    """The main path with ``audit=True``: each flagged slot equals the
    float64 oracle, each other slot the unaudited count bit for bit, and
    every slot's counts lie within :data:`AUDIT_RTOL` of the oracle. The
    flag kernel runs once per count, the plain flag pass never on the
    card, and a rerun with the plain flag pass flags the same slots."""
    import numpy as np

    from yet_another_wizz_tpu_torch.correlation.measurements import (
        PatchLinkage,
        crosscorrelate,
    )
    from yet_another_wizz_tpu_torch.ops import paircount
    from yet_another_wizz_tpu_torch.ops.cuda_paircount import FLAG_KERNELS
    from yet_another_wizz_tpu_torch.ops.tiles import DEFAULT_TILE_SIZE

    reference, unknown, randoms = catalogs
    workers = len(os.sched_getaffinity(0))

    def audited():
        return crosscorrelate(
            config, reference, unknown, ref_rand=randoms, device="cuda",
            audit=True, max_workers=workers,
        )

    paircount.reset_audit_stats()
    with flag_spy() as plain_calls:
        (corr,), _ = run_path(
            "audit (crosscorrelate, audit=True)", audited,
            {"paircount_partials": 2, "paircount_segment_sum": 2,
             **dict.fromkeys(FLAG_KERNELS, 2)},
            launches_total,
        )
    check(plain_calls[0] == 0, "audit: the plain flag pass ran on the card")
    check(len(paircount.AUDIT_STATS) == 2, "audit: not one audit per count")
    first = list(paircount.AUDIT_STATS)
    paircount.reset_audit_stats()
    # warm runs under a profiler of the host: the flag passes and recounts
    # are its spans audit.flag and audit.recount
    (again,), warm, warm_spans = host_spans(audited)
    rerun_stats = list(paircount.AUDIT_STATS)
    paircount.reset_audit_stats()
    with plain_flag_pass():
        _, plain_warm, plain_spans = host_spans(audited)
    plain_stats = list(paircount.AUDIT_STATS)
    check(same_flagged_slots(first, plain_stats),
          "audit: the plain flag pass flags other slots than the kernel")
    links = PatchLinkage.from_catalogs(config, *catalogs)
    num_edges = links.edges.chord2_table.shape[1]
    for (name, stats), rerun in zip(zip(("DD", "RD"), first), rerun_stats):
        oracle, pairs = oracles[name]
        flagged = stats["flagged_slots"]
        check(np.array_equal(rerun["flagged_slots"], flagged),
              f"audit {name}: the second run flagged other slots")
        unflagged = np.setdiff1d(np.arange(pairs.num_slots), flagged)
        ours = main_path_counts(getattr(corr, name.lower()), pairs, False)
        plain = main_path_counts(getattr(wsp, name.lower()), pairs, False)
        expected = links.edges.counts_to_scales(oracle)[0]
        flagged_err = slot_relative_error(ours[flagged], expected[flagged])
        slot_err = slot_relative_error(ours, expected)
        plain_err = slot_relative_error(plain, expected)
        bound_ms, bound_by = flag_pass_bound(
            pairs.num_pairs, num_edges, DEFAULT_TILE_SIZE
        )
        log(f"[{card}] audit {name}: {len(flagged)} of {pairs.num_slots} slots "
            f"flagged ({pairs.num_pairs} tile pairs; the plain flag pass's "
            f"rerun the same); flag pass every-pair bound "
            f"{bound_ms:.3f} ms ({bound_by}); float64 recount on "
            f"{stats['recount_workers']} threads; flagged slots vs "
            f"oracle max rel {flagged_err:.3e}; unflagged slots bitwise the "
            f"unaudited counts; per-slot max rel vs oracle {slot_err:.3e} "
            f"(unaudited {plain_err:.3e})")
        check(flagged_err <= AUDIT_EXACT,
              f"audit {name}: a flagged slot is not the oracle's")
        check(np.array_equal(ours[unflagged], plain[unflagged]),
              f"audit {name}: an unflagged slot differs from the unaudited count")
        check(slot_err <= AUDIT_RTOL, f"audit {name}: per-slot counts off the oracle")
    check(same_counts(again, corr), "audit: the warm run differs from the first")
    log(f"[{card}] audit (crosscorrelate + audit, DD + RD): warm {warm:.2f} s "
        f"under a host profiler (flag passes "
        f"{warm_spans['audit.flag'][1] * 1e3:.3f} ms of host, recounts "
        f"{warm_spans['audit.recount'][1]:.2f} s); with the plain flag pass "
        f"{plain_warm:.2f} s (flag passes "
        f"{plain_spans['audit.flag'][1] * 1e3:.1f} ms)")


def audit_flip(card, launches_total) -> None:
    """The engineered on-edge pair (``tests/torch_audit_cases.py``, the JAX
    package's ``TestBoundaryAudit``) on the card: K1.1 puts the whole 1e4
    pair weight on the wrong side of the edge, the audit repairs it."""
    import numpy as np

    from yet_another_wizz_tpu_torch.ops.cpu_oracle import count_pairs_oracle
    from yet_another_wizz_tpu_torch.ops.cuda_paircount import FLAG_KERNELS
    from yet_another_wizz_tpu_torch.ops.paircount import count_pairs_tiles

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "tests"))
    import torch_audit_cases as cases

    from yet_another_wizz_tpu_torch.ops import paircount

    case = cases.on_edge_case(np.random.default_rng(12345), 1.0)
    tiles1, tiles2, pairs = cases.port_inputs(case)
    expected = count_pairs_oracle(*cases.oracle_inputs(case, pairs))

    def count(audit):
        return count_pairs_tiles(
            tiles1, tiles2, pairs, case["chord2"], backend="cuda",
            device="cuda", edges_radian=case["edges"], audit=audit,
        )

    paircount.reset_audit_stats()
    with flag_spy() as plain_calls:
        (raw, fixed), _ = run_path(
            "audit flip (engineered on-edge pair)",
            lambda: (count(False), count(True)),
            {"paircount_partials": 2, "paircount_segment_sum": 2,
             **dict.fromkeys(FLAG_KERNELS, 1)},
            launches_total,
        )
    check(plain_calls[0] == 0, "audit flip: the plain flag pass ran on the card")
    kernel_stats = list(paircount.AUDIT_STATS)
    paircount.reset_audit_stats()
    with plain_flag_pass():
        count(True)
    check(same_flagged_slots(kernel_stats, paircount.AUDIT_STATS),
          "audit flip: the plain flag pass flags other slots than the kernel")
    raw_err = np.abs(raw - expected).max()
    fixed_err = np.abs(fixed - expected).max()
    log(f"[{card}] audit flip: unaudited K1.1 off the oracle by {raw_err:.6f} "
        f"(the pair weight is 1e4), audited by {fixed_err:.3e}; "
        f"{len(kernel_stats[0]['flagged_slots'])} slot(s) flagged by the "
        "kernel, the same by the plain flag pass")
    check(raw_err >= 0.999e4, "audit flip: the engineered pair did not flip")
    check(fixed_err <= 1e-3, "audit flip: the audit did not repair the flip")


def audit_blocked(card, config, launches_total) -> None:
    """Blocked ``autocorrelate(audit=True)`` against the in-memory audited
    run, on the benchmark's catalogs cut by :data:`AUDIT_CUT`."""
    import numpy as np

    from yet_another_wizz_tpu_torch.catalog import Catalog
    from yet_another_wizz_tpu_torch.correlation.measurements import autocorrelate
    from yet_another_wizz_tpu_torch.examples import generate_mock_data
    from yet_another_wizz_tpu_torch.ops import paircount
    from yet_another_wizz_tpu_torch.ops.cuda_paircount import FLAG_KERNELS

    def flagged() -> int:
        return sum(len(stats["flagged_slots"]) for stats in paircount.AUDIT_STATS)

    mock = generate_mock_data(
        num_reference=NUM_REFERENCE // AUDIT_CUT, num_unknown=1,
        num_randoms=NUM_RANDOMS // AUDIT_CUT, seed=SEED,
    )
    data = Catalog.from_arrays(
        **mock["reference"], degrees=False, patch_num=NUM_PATCHES, device="cuda"
    )
    random = Catalog.from_arrays(
        **mock["randoms"], degrees=False, patch_centers=data.get_centers(),
        device="cuda",
    )
    run = dict(device="cuda", audit=True, max_workers=len(os.sched_getaffinity(0)))
    paircount.reset_audit_stats()
    t0 = time.perf_counter()
    (memory,) = autocorrelate(config, data, random, **run)
    t_memory = time.perf_counter() - t0
    flagged_memory = flagged()
    paircount.reset_audit_stats()

    def blocked_run():
        return autocorrelate(
            config, data, random, max_resident_patches=AUDIT_RESIDENT, **run
        )

    t0 = time.perf_counter()
    with flag_spy() as plain_calls:
        (blocked,), _ = run_path(
            "audit blocked (autocorrelate, audit=True, max_resident_patches="
            f"{AUDIT_RESIDENT})",
            blocked_run,
            {"paircount_partials_binned": 3, "paircount_segment_sum": 3,
             **dict.fromkeys(FLAG_KERNELS, 3)},
            launches_total,
        )
    t_blocked = time.perf_counter() - t0
    check(plain_calls[0] == 0, "audit blocked: the plain flag pass ran on the card")
    kernel_stats = list(paircount.AUDIT_STATS)
    flagged_blocked = flagged()
    paircount.reset_audit_stats()
    _, _, kernel_spans = host_spans(blocked_run)
    paircount.reset_audit_stats()
    with plain_flag_pass():
        _, t_plain, plain_spans = host_spans(blocked_run)
    check(same_flagged_slots(kernel_stats, paircount.AUDIT_STATS),
          "audit blocked: the plain flag pass flags other slots than the kernel")
    flag_ms = kernel_spans["audit.flag"][1] * 1e3
    plain_ms = plain_spans["audit.flag"][1] * 1e3
    errs = []
    for name in ("dd", "dr", "rr"):
        ours = getattr(blocked, name).counts.counts
        expected = getattr(memory, name).counts.counts
        errs.append(np.abs(ours - expected).max() / np.abs(expected).max())
    log(f"[{card}] audit blocked ({NUM_REFERENCE // AUDIT_CUT} + "
        f"{NUM_RANDOMS // AUDIT_CUT} points, {NUM_PATCHES} patches): in memory "
        f"{t_memory:.2f} s ({flagged_memory} slots recounted over DD, DR, RR), "
        f"blocked {t_blocked:.2f} s ({flagged_blocked} block-pair slots "
        f"recounted; {len(kernel_stats)} flag passes, {flag_ms:.3f} ms of host "
        f"in them (span audit.flag, a rerun under a host profiler); with the "
        f"plain flag pass {t_plain:.2f} s, {plain_ms:.1f} ms, the same slots "
        "flagged); blocked vs in-memory max|err|/max DD, DR, RR "
        + ", ".join(f"{e:.3e}" for e in errs))
    check(flagged_memory > 0, "audit blocked: no slot was flagged")
    check(max(errs) <= RTOL, "audit blocked: off the in-memory audited counts")


# -- paths ----------------------------------------------------------------------


def run_path(name: str, fn, expected: dict, launches_total: dict):
    """Drive one path with the launch counts set to 0 just before it; check
    that each expected variant launched at least as often as given."""
    import torch

    from yet_another_wizz_tpu_torch.utils import tracing

    tracing.reset()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counted_launches()
    log(f"{name} path (cold) {seconds:.2f} s, kernel launches {launches}")
    for variant, count in expected.items():
        check(launches.get(variant, 0) >= count,
              f"{name}: {variant} launched {launches.get(variant, 0)} times, "
              f"expected at least {count}")
    for variant, count in launches.items():
        launches_total[variant] = launches_total.get(variant, 0) + count
    return result, launches


def check_nz(nz, label: str, num_patches: int = NUM_PATCHES) -> None:
    import numpy as np

    for field in ("data", "error", "covariance"):
        check(bool(np.all(np.isfinite(getattr(nz, field)))),
              f"{label} n(z) {field} is not finite")
    check(nz.data.shape == (NUM_BINS,), f"{label} n(z) has the wrong shape")
    check(nz.samples.shape == (num_patches, NUM_BINS), f"{label} wrong sample shape")


def warm_time(fn, runs: int = WARM_RUNS) -> tuple[float, float, float]:
    import torch

    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), min(times), max(times)


def engine_times(card, label, links, catalogs, counts) -> float:
    """Kernel milliseconds (CUDA events) of each count of a path, with its
    candidate pairs; returns the sum."""
    from yet_another_wizz_tpu_torch.ops.paircount import count_pairs_tiles

    table, _, direct, _ = links.engine_table()
    total = 0.0
    for count in counts:
        tiles1, tiles2, pairs = engine_inputs(links, catalogs, count)

        def run():
            return count_pairs_tiles(
                tiles1, tiles2, pairs, table, backend="cuda", device="cuda",
                defer=True, direct=direct,
            )

        ms = cuda_ms(run, 3)
        candidates = pairs.num_pairs * tiles1.tile_size ** 2
        total += ms
        log(f"[{card}] {label} {count} ({pairs.num_pairs} tile pairs, "
            f"{candidates:.4e} candidate pairs): kernels {ms:.3f} ms "
            f"({candidates / (ms * 1e-3):.4e} pairs/s)")
    return total


# -- sharded and multi-process phases -------------------------------------------


def sharded_mesh():
    """The mesh of the sharded phases (see :data:`SHARDS`)."""
    import torch

    from yet_another_wizz_tpu_torch.parallel import Mesh

    if torch.cuda.device_count() >= SHARDS:
        return Mesh([f"cuda:{i}" for i in range(SHARDS)])
    return Mesh(["cuda:0"] * SHARDS)


def plan_steps(links, catalogs, counts, layout, num_shards, shards=None) -> int:
    """Non-empty (shard, step) sub-lists of the counts' shard plans over
    ``shards`` (default all): kernel A and kernel B launch once for each."""
    from yet_another_wizz_tpu_torch.parallel import sharded

    steps = 0
    for count in counts:
        tiles1, tiles2, pairs = engine_inputs(links, catalogs, count)
        plan = sharded._shard_plan(pairs, tiles1, tiles2, num_shards, layout)
        steps += sum(len(plan[d]) for d in (shards or range(num_shards)))
    return steps


def relative_error(actual, desired) -> float:
    import numpy as np

    return float(np.abs(actual - desired).max() / np.abs(desired).max())


def corr_error(corr, desired, names) -> float:
    return max(
        relative_error(getattr(corr, name).counts.counts,
                       getattr(desired, name).counts.counts)
        for name in names
    )


def sharded_case(card, label, run, single, names, launches_total, *, links,
                 catalogs, counts, layout, mesh, variant, rtol=RTOL) -> None:
    """One sharded measurement: launches once per non-empty step, counts and
    n(z) of every scale against the single-device run, two runs bitwise
    equal, and the warm median beside the single-device warm time."""
    import numpy as np

    from yet_another_wizz_tpu_torch.redshifts import RedshiftData

    corrs, launches = run_path(
        label, run, {variant: 1, "paircount_segment_sum": 1}, launches_total
    )
    steps = plan_steps(links, catalogs, counts, layout, mesh.size)
    check(launches.get(variant) == steps == launches.get("paircount_segment_sum"),
          f"{label}: launches {launches}, expected {steps} per kernel (one per "
          "non-empty shard and step)")
    err = max(corr_error(c, s, names) for c, s in zip(corrs, single))
    nz_err = 0.0
    if "rd" in names:
        for c, s in zip(corrs, single):
            ours, theirs = (RedshiftData.from_corrfuncs(x) for x in (c, s))
            nz_err = max(nz_err, relative_error(ours.data, theirs.data),
                         relative_error(ours.samples, theirs.samples))
    again = run()
    bitwise = all(
        np.array_equal(getattr(a, name).counts.counts, getattr(b, name).counts.counts)
        for a, b in zip(again, corrs) for name in names
    )
    check(err <= rtol and nz_err <= rtol,
          f"{label}: off the single-device run ({err:.3e}, n(z) {nz_err:.3e})")
    check(bitwise, f"{label}: two runs differ")
    warm, lo, hi = warm_time(run, SHARDED_WARM_RUNS)
    log(f"[{card}] {label}: warm {warm:.4f} s (median of {SHARDED_WARM_RUNS}) "
        f"[{lo:.4f}, {hi:.4f}]; {steps} kernel A + {steps} kernel B launches "
        f"({launches}); counts vs single device max|err|/max {err:.3e}, n(z) "
        f"{nz_err:.3e}; two runs bitwise equal")


def sharded_phase(card, configs, catalogs, single, launches_total) -> None:
    """The headline ``crosscorrelate`` under every layout, ``autocorrelate``
    and config B's cross count under ``ring``, on :func:`sharded_mesh`
    against the single-device runs ``single``; then the cross-shard sum (the
    ``psum``'s counterpart) timed against its byte bound."""
    import torch

    from yet_another_wizz_tpu_torch.correlation.measurements import (
        PatchLinkage,
        autocorrelate,
        crosscorrelate,
    )
    from yet_another_wizz_tpu_torch.parallel import sharded
    from yet_another_wizz_tpu_torch.redshifts import RedshiftData

    mesh = sharded_mesh()
    config, config_b = configs["headline"], configs["B"]
    reference, unknown, randoms = catalogs
    log(f"{mesh} on a machine with {torch.cuda.device_count()} card(s)")
    warm, lo, hi = warm_time(
        lambda: RedshiftData.from_corrfuncs(crosscorrelate(
            config, reference, unknown, ref_rand=randoms, device="cuda",
            mesh="single",
        )[0]),
        SHARDED_WARM_RUNS,
    )
    log(f"[{card}] single device crosscorrelate + n(z): warm {warm:.4f} s "
        f"(median of {SHARDED_WARM_RUNS}) [{lo:.4f}, {hi:.4f}]")
    links = PatchLinkage.from_catalogs(config, *catalogs)
    for layout in LAYOUTS:
        def cross(layout=layout):
            corrs = crosscorrelate(
                config, reference, unknown, ref_rand=randoms, device="cuda",
                mesh=mesh, data_sharding=layout,
            )
            RedshiftData.from_corrfuncs(corrs[0])
            return corrs

        sharded_case(
            card, f"sharded crosscorrelate + n(z) ({layout}, {mesh.size} shards)",
            cross, single["cross"], ("dd", "rd"), launches_total, links=links,
            catalogs=catalogs, counts=("cross DD", "cross RD"), layout=layout,
            mesh=mesh, variant="paircount_partials",
        )
    sharded_case(
        card, f"sharded autocorrelate (ring, {mesh.size} shards)",
        lambda: autocorrelate(
            config, reference, randoms, device="cuda", mesh=mesh,
            data_sharding="ring",
        ),
        single["auto"], ("dd", "dr", "rr"), launches_total, links=links,
        catalogs=catalogs, counts=("auto DD", "auto DR", "auto RR"),
        layout="ring", mesh=mesh, variant="paircount_partials_binned",
    )
    sharded_case(
        card, f"sharded config B crosscorrelate (ring, {mesh.size} shards, direct)",
        lambda: crosscorrelate(
            config_b, reference, unknown, ref_rand=randoms, device="cuda",
            mesh=mesh, data_sharding="ring",
        ),
        single["B"], ("dd", "rd"), launches_total,
        links=PatchLinkage.from_catalogs(config_b, *catalogs), catalogs=catalogs,
        counts=("cross DD", "cross RD"), layout="ring", mesh=mesh,
        variant="paircount_partials_direct", rtol=DIRECT_RTOL,
    )

    # the reduction: N partials of the headline DD's shape summed in shard
    # order on the first device; its bound reads N partials and writes one
    _, _, pairs = engine_inputs(links, catalogs, "cross DD")
    shape = (pairs.num_slots, NUM_BINS, links.edges.num_counting_edges)
    generator = torch.Generator(device="cpu").manual_seed(SEED)
    host = [torch.rand(shape, generator=generator) for _ in range(mesh.size)]
    parts = [h.to(device) for h, device in zip(host, mesh.devices)]
    expected = host[0].clone()
    for h in host[1:]:
        expected += h
    total = sharded._sum_partials([p.clone() for p in parts], mesh.devices[0])
    check(torch.equal(total.cpu(), expected), "the cross-shard sum is not in shard order")
    reps = 20

    def sums():
        for _ in range(reps):
            sharded._sum_partials(parts, mesh.devices[0])

    ms = cuda_ms(sums, KERNEL_REPS) / reps
    num_bytes = (mesh.size + 1) * parts[0].numel() * 4
    log(f"[{card}] cross-shard sum of {mesh.size} partials {tuple(shape)} "
        f"float32: {ms * 1e3:.2f} us per sum ({mesh.size - 1} torch adds, host "
        f"launches included); bound {num_bytes / HBM_RATE * 1e6:.4f} us "
        f"({num_bytes} B over {HBM_RATE:.3g} B/s); equal to the host sum in "
        "shard order")


def mp_child(root: str) -> None:
    """A process of the two-process phase: join the gloo job, open the
    headline catalogs from the caches under ``root`` and run
    ``crosscorrelate`` on the global mesh of 2 x 2 shards in every layout;
    every layout's counts must equal the parent's single-process 4-shard
    counts bit for bit. Prints one JSON line."""
    import numpy as np
    import torch

    from yet_another_wizz_tpu_torch.catalog import Catalog
    from yet_another_wizz_tpu_torch.config import Configuration
    from yet_another_wizz_tpu_torch.correlation.measurements import (
        PatchLinkage,
        crosscorrelate,
    )
    from yet_another_wizz_tpu_torch.ops import cuda_paircount
    from yet_another_wizz_tpu_torch.utils import tracing
    from yet_another_wizz_tpu_torch.parallel import default_mesh, distributed

    t_start = time.perf_counter()
    rank = int(os.environ["YAWT_PROCESS_ID"])
    device = f"cuda:{rank}" if torch.cuda.device_count() >= MP_PROCESSES else "cuda:0"
    torch.cuda.set_device(device)
    cuda_paircount.build()
    distributed.initialize()
    check(distributed.num_processes() == MP_PROCESSES, "the job is not two processes")
    mesh = default_mesh(SHARDS, device)
    per_process = SHARDS // MP_PROCESSES
    check(mesh.ranks == tuple(r for r in range(MP_PROCESSES) for _ in range(per_process)),
          f"not a rank-major global mesh: {mesh}")
    config = Configuration.create(**CONFIG)
    catalogs = [Catalog(os.path.join(root, name)) for name in CATALOG_NAMES]
    expected = np.load(os.path.join(root, "expected.npz"))
    links = PatchLinkage.from_catalogs(config, *catalogs)
    report = dict(rank=rank, device=device, mesh=repr(mesh), layouts={})
    for layout in LAYOUTS:
        times = []
        for _ in range(2):
            tracing.reset()
            t0 = time.perf_counter()
            (corr,) = crosscorrelate(
                config, catalogs[0], catalogs[1], ref_rand=catalogs[2],
                device=device, mesh=mesh, data_sharding=layout,
            )
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            for name in ("dd", "rd"):
                ours = getattr(corr, name).counts.counts
                theirs = expected[f"{layout}_{name}"]
                check(np.array_equal(ours, theirs),
                      f"rank {rank} {layout} {name}: not the single-process "
                      f"{SHARDS}-shard counts (max diff "
                      f"{np.abs(ours - theirs).max():.3e})")
        steps = plan_steps(links, catalogs, ("cross DD", "cross RD"), layout,
                           mesh.size, mesh.local_shards())
        launches = counted_launches()
        check(launches.get("paircount_partials") == steps
              == launches.get("paircount_segment_sum"),
              f"rank {rank} {layout}: launches {launches}, expected {steps}")
        report["layouts"][layout] = dict(cold_s=times[0], warm_s=times[1],
                                         launches=steps)
    check(distributed.broadcast({"rank": rank}) == {"rank": 0}, "broadcast")
    check(distributed.run_on_root(lambda: rank) == 0, "run_on_root")
    distributed.barrier()
    report["seconds"] = time.perf_counter() - t_start
    print(json.dumps(report), flush=True)


def two_process_phase(card, config, catalogs) -> None:
    """Write the headline catalogs to caches (``Catalog.to_cache``, root
    only), count them here on one process's mesh of 4 shards in every
    layout, then start two children of this script (``--mp-child``) wired
    with ``YAWT_*`` on localhost, which must reproduce those counts bit for
    bit on the global mesh of 2 x 2 shards. A child's failure fails the
    phase."""
    import shutil
    import socket
    import tempfile

    import numpy as np

    from yet_another_wizz_tpu_torch.catalog import Catalog
    from yet_another_wizz_tpu_torch.correlation.measurements import crosscorrelate
    from yet_another_wizz_tpu_torch.parallel import Mesh

    root = tempfile.mkdtemp(prefix="yawt_mp_")
    procs = []
    try:
        t0 = time.perf_counter()
        for name, catalog in zip(CATALOG_NAMES, catalogs):
            catalog.to_cache(os.path.join(root, name))
        reopened = [Catalog(os.path.join(root, name)) for name in CATALOG_NAMES]
        mesh = Mesh(["cuda:0"] * SHARDS)
        expected = {}
        for layout in LAYOUTS:
            (corr,) = crosscorrelate(
                config, reopened[0], reopened[1], ref_rand=reopened[2],
                device="cuda", mesh=mesh, data_sharding=layout,
            )
            for name in ("dd", "rd"):
                expected[f"{layout}_{name}"] = getattr(corr, name).counts.counts
        np.savez(os.path.join(root, "expected.npz"), **expected)
        del reopened
        log(f"two processes: caches written and single-process {SHARDS}-shard "
            f"counts taken in {time.perf_counter() - t0:.2f} s")

        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        logs = [os.path.join(root, f"child_{rank}.log") for rank in range(MP_PROCESSES)]
        for rank in range(MP_PROCESSES):
            env = {k: v for k, v in os.environ.items() if k != "YAWT_NUM_DEVICES"}
            env.update(YAWT_COORDINATOR=f"localhost:{port}",
                       YAWT_NUM_PROCESSES=str(MP_PROCESSES), YAWT_PROCESS_ID=str(rank))
            with open(logs[rank], "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--mp-child", root],
                    env=env, stdout=out, stderr=subprocess.STDOUT,
                ))

        def tail(rank: int) -> str:
            with open(logs[rank]) as out:
                return out.read()[-3000:]

        # a child that fails leaves its peer waiting in a collective: stop
        # both at the first failure
        while any(proc.poll() is None for proc in procs):
            for rank, proc in enumerate(procs):
                check(proc.poll() in (None, 0),
                      f"two processes: child {rank} failed:\n{tail(rank)}")
            check(time.perf_counter() - t0 < MP_TIMEOUT,
                  f"two processes: the children did not end in {MP_TIMEOUT} s:\n"
                  + "\n".join(tail(rank) for rank in range(MP_PROCESSES)))
            time.sleep(0.2)
        seconds = time.perf_counter() - t0
        for rank, proc in enumerate(procs):
            check(proc.returncode == 0,
                  f"two processes: child {rank} failed:\n{tail(rank)}")
        outputs = [json.loads(tail(rank).strip().splitlines()[-1])
                   for rank in range(MP_PROCESSES)]
        for report in outputs:
            layouts = ", ".join(
                f"{layout} {r['cold_s']:.2f} s cold / {r['warm_s']:.3f} s warm, "
                f"{r['launches']} K1.1 + {r['launches']} B launches"
                for layout, r in report["layouts"].items()
            )
            log(f"[{card}] two processes, rank {report['rank']} on "
                f"{report['device']} ({report['mesh']}): {layouts}; "
                f"{report['seconds']:.1f} s in the child")
        log(f"[{card}] two processes x {SHARDS // MP_PROCESSES} shards: every "
            f"layout bitwise the single-process {SHARDS}-shard counts on both "
            f"ranks; broadcast and run_on_root behave; {seconds:.1f} s from "
            "start to exit")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(root, ignore_errors=True)


# -- survey path (blocked, out of core) ----------------------------------------


def write_survey_caches(root: str) -> None:
    """The survey's three catalog caches under ``root``: mocks, 96 kmeans
    patches on the reference, HEALPix-mask randoms drawing the reference's
    redshifts (``bench.py:499-530``)."""
    import numpy as np

    from yet_another_wizz_tpu_torch.catalog import Catalog
    from yet_another_wizz_tpu_torch.examples import generate_mock_data
    from yet_another_wizz_tpu_torch.randoms import HealPixRandoms
    from yet_another_wizz_tpu_torch.utils.healpix import pix2ang_ring

    mock = generate_mock_data(**SURVEY_SIZES, num_randoms=1, seed=SURVEY_SEED)
    reference = Catalog.from_arrays(
        **mock["reference"], degrees=False, patch_num=SURVEY_PATCHES,
        cache_directory=os.path.join(root, "reference"), device="cuda",
    )
    centers = reference.get_centers()
    Catalog.from_arrays(
        **mock["unknown"], degrees=False, patch_centers=centers,
        cache_directory=os.path.join(root, "unknown"), device="cuda",
    )
    colat, lon = pix2ang_ring(SURVEY_NSIDE, np.arange(12 * SURVEY_NSIDE**2))
    ra, dec = np.rad2deg(lon), 90.0 - np.rad2deg(colat)
    mask = ((ra >= 40) & (ra <= 60) & (dec >= -10) & (dec <= 10)).astype(float)
    generator = HealPixRandoms(
        mask, redshifts=mock["reference"]["redshifts"], seed=SURVEY_RANDOM_SEED
    )
    Catalog.from_random(
        os.path.join(root, "randoms"), generator, SURVEY_RANDOMS,
        patch_centers=centers, device="cuda",
    )


def survey_run(config, catalogs, mesh=None, data_sharding="replicated",
               audit=False, spans=False, **budgets):
    """One survey measurement (blocked ``crosscorrelate`` DD + RD and the
    jackknife n(z)) in a tile cache of its own, with the ``budgets`` of
    ``measurement_tile_cache``, on one device or sharded over ``mesh``,
    audited with ``audit``: ``(w_sp, n(z), stats)``, with the run's
    counters and the cache's statistics in ``stats``. With ``spans`` the
    run is under a profiler of the host (which slows it), and ``stats``
    also holds its phase totals from the spans and, audited, the flag
    passes' and recounts' host seconds (``audit_flag``,
    ``audit_recount``)."""
    import torch

    from yet_another_wizz_tpu_torch.correlation import blocked
    from yet_another_wizz_tpu_torch.correlation.measurements import crosscorrelate
    from yet_another_wizz_tpu_torch.redshifts import RedshiftData
    from yet_another_wizz_tpu_torch.utils import tracing

    def run():
        (wsp,) = crosscorrelate(
            config, catalogs[0], catalogs[1], ref_rand=catalogs[2],
            max_resident_patches=SURVEY_RESIDENT, device="cuda", mesh=mesh,
            data_sharding=data_sharding, audit=audit,
            max_workers=len(os.sched_getaffinity(0)) if audit else None,
        )
        return wsp, RedshiftData.from_corrfuncs(wsp)

    tracing.reset()
    found = {}
    with blocked.measurement_tile_cache(**budgets) as cache:
        if spans:
            (wsp, nz), _, found = host_spans(run)
        else:
            wsp, nz = run()
    torch.cuda.synchronize()
    stats = {}
    if spans:
        for key in SURVEY_PHASES:
            stats[key] = found.get(f"blocked.{key}", (0, 0.0))[1]
        if audit:
            for key in ("flag", "recount"):
                stats[f"audit_{key}"] = found.get(f"audit.{key}", (0, 0.0))[1]
    for key, name in SURVEY_COUNTERS.items():
        stats[key] = tracing.counters.get(name, 0)
    for key in ("hits", "misses", "evictions", "spills", "spill_loads"):
        stats[f"cache_{key}"] = getattr(cache, key)
    return wsp, nz, stats


def format_stats(stats: dict) -> str:
    return ", ".join(
        f"{key} {value:.3f} s" if isinstance(value, float) else f"{key} {value}"
        for key, value in stats.items()
    )


def same_counts(corr, other) -> bool:
    import numpy as np

    return all(
        np.array_equal(getattr(corr, name).counts.counts, getattr(other, name).counts.counts)
        for name in ("dd", "rd")
    )


def survey_child(kind: str, root: str, out: str) -> None:
    """The survey path's child process: open the caches as ``Catalog`` or
    ``LazyCatalog``, run the measurement once, save its DD and RD counts to
    ``out`` and print, as one JSON line, its host memory by kind before
    opening, after opening and at the peak of the run (sampled), with the
    process's peak resident set. A blocked measurement on small in-memory
    mocks runs first, so that the memory the CUDA libraries take on first
    use is in the baseline."""
    import gc
    import resource

    import numpy as np

    from yet_another_wizz_tpu_torch.catalog import Catalog, LazyCatalog
    from yet_another_wizz_tpu_torch.config import Configuration
    from yet_another_wizz_tpu_torch.examples import generate_mock_data

    config = Configuration.create(**CONFIG)
    mock = generate_mock_data(20_000, 40_000, 80_000, seed=SURVEY_SEED)
    warm_up = [Catalog.from_arrays(
        **mock["reference"], degrees=False, patch_num=SURVEY_PATCHES, device="cuda"
    )]
    warm_up += [
        Catalog.from_arrays(**mock[name], degrees=False,
                            patch_centers=warm_up[0].get_centers(), device="cuda")
        for name in ("unknown", "randoms")
    ]
    survey_run(config, warm_up)
    del mock, warm_up
    gc.collect()
    base = host_memory()
    with MemorySampler() as sampler:
        t0 = time.perf_counter()
        catalog_cls = LazyCatalog if kind == "lazy" else Catalog
        catalogs = [catalog_cls(os.path.join(root, name)) for name in SURVEY_NAMES]
        t_open = time.perf_counter() - t0
        opened = host_memory()
        wsp, _, stats = survey_run(config, catalogs)
        seconds = time.perf_counter() - t0
    np.savez(out, dd=wsp.dd.counts.counts, rd=wsp.rd.counts.counts)
    print(json.dumps(dict(
        kind=kind, rows=sum(sum(c.get_num_records()) for c in catalogs),
        base=base, opened=opened, peak=sampler.peak,
        max_rss=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
        open_s=t_open, total_s=seconds, stats=stats,
    )))


def survey_budgets(card, config, catalogs, first) -> None:
    """The survey under a resident budget below its lanes (evictions, disk
    spills and reloads), and with both budgets 0 (every block loaded from
    the tile store and uploaded each sweep): bitwise the first run."""
    import torch

    log(f"-- survey: binding resident budget ({SURVEY_BUDGET >> 20} MiB), "
        "each run in a tile cache of its own")
    torch.cuda.reset_peak_memory_stats()
    times = []
    for run in range(SURVEY_WARM_RUNS):
        t0 = time.perf_counter()
        wsp, _, stats = survey_run(config, catalogs, resident_tile_bytes=SURVEY_BUDGET)
        times.append(time.perf_counter() - t0)
        log(f"[{card}] survey budget {SURVEY_BUDGET >> 20} MiB run {run}: "
            f"{times[-1]:.3f} s; {format_stats(stats)}")
        check(same_counts(wsp, first), "survey: a binding-budget run differs")
        binding = ("evictions", "spills", "spill_loads")
        check(min(stats[f"cache_{key}"] for key in binding) > 0,
              "survey: the budget did not bind (no eviction, spill or reload)")
    log(f"[{card}] survey budget {SURVEY_BUDGET >> 20} MiB: warm "
        f"{statistics.median(times):.3f} s (median of {SURVEY_WARM_RUNS}) "
        f"[{min(times):.3f}, {max(times):.3f}], bitwise the first run; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wsp, _, stats = survey_run(
        config, catalogs, tile_cache_bytes=0, resident_tile_bytes=0
    )
    seconds = time.perf_counter() - t0
    check(same_counts(wsp, first), "survey: the run without tile caches differs")
    check(stats["cache_hits"] == 0, "survey: a cache without budget was hit")
    log(f"[{card}] survey with both budgets 0 (every block loaded and uploaded "
        f"each sweep): {seconds:.3f} s, bitwise the first run; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; "
        f"{format_stats(stats)}")


def survey_hist(card, config, catalogs, root) -> None:
    """``HistData.from_catalog`` on the survey's unknown sample, from the
    ``Catalog`` and from a ``LazyCatalog`` in blocks: bitwise equal, and
    each bin the sample's weight sum in it."""
    import numpy as np

    from yet_another_wizz_tpu_torch.catalog import LazyCatalog
    from yet_another_wizz_tpu_torch.redshifts import HistData

    unknown = catalogs[1]
    t0 = time.perf_counter()
    memory = HistData.from_catalog(unknown, config)
    t_memory = time.perf_counter() - t0
    t0 = time.perf_counter()
    lazy = HistData.from_catalog(
        LazyCatalog(os.path.join(root, "unknown")), config,
        max_resident_patches=SURVEY_RESIDENT,
    )
    t_lazy = time.perf_counter() - t0
    check(np.array_equal(lazy.data, memory.data)
          and np.array_equal(lazy.samples, memory.samples),
          "hist: LazyCatalog and Catalog differ")
    z = unknown.redshifts
    w = unknown.weights if unknown.weights is not None else np.ones(len(z))
    bins = config.binning.binning.digitize(z) - 1
    expected = np.array([w[bins == b].sum() for b in range(NUM_BINS)])
    err = slot_relative_error(memory.data, expected)
    log(f"[{card}] hist (HistData.from_catalog, {len(z)} unknown rows, "
        f"{unknown.num_patches} patches): Catalog {t_memory:.3f} s, LazyCatalog "
        f"in blocks of {SURVEY_RESIDENT} patches {t_lazy:.3f} s, bitwise equal; "
        f"per-bin weight sums max rel {err:.3e}")
    check(memory.data.shape == (NUM_BINS,) and bool(np.all(np.isfinite(memory.error))),
          "hist: wrong shape or non-finite errors")
    check(err <= 1e-12, "hist: a bin is not the sample's weight sum in it")


def survey_path(card, config, launches_total) -> None:
    """The survey path on caches in a temporary directory, removed at the
    end (see the module docstring)."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="yawt_survey_")
    try:
        survey_checks(card, config, launches_total, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def audit_survey(card) -> None:
    """The audit at survey size: the survey cell's blocked
    ``crosscorrelate`` (caches in a temporary directory, removed at the
    end) warm without the audit, then with ``audit=True``. Logs both
    times, the flag passes (one flag kernel launch each, the plain flag
    pass never on the card) and their milliseconds, the recounted slots
    and the float64 recount's seconds. The audited counts of the slots
    the audit moved most, and of evenly spaced ones, lie within
    :data:`RTOL` of the float64 oracle (max|err| over the largest count,
    the survey's oracle gate; the unaudited counts beside them)."""
    import shutil
    import tempfile

    import numpy as np

    from yet_another_wizz_tpu_torch.catalog import Catalog
    from yet_another_wizz_tpu_torch.config import Configuration
    from yet_another_wizz_tpu_torch.correlation.measurements import PatchLinkage
    from yet_another_wizz_tpu_torch.ops import paircount
    from yet_another_wizz_tpu_torch.ops.cuda_paircount import FLAG_KERNELS

    config = Configuration.create(**CONFIG)
    root = tempfile.mkdtemp(prefix="yawt_audit_survey_")
    try:
        write_survey_caches(root)
        catalogs = tuple(Catalog(os.path.join(root, name)) for name in SURVEY_NAMES)
        survey_run(config, catalogs)  # fills the tile store
        t0 = time.perf_counter()
        plain, _, _ = survey_run(config, catalogs)
        t_plain = time.perf_counter() - t0
        paircount.reset_audit_stats()
        t0 = time.perf_counter()
        with flag_spy() as plain_calls:
            (audited, nz, stats), launches = run_path(
                "survey audit (blocked crosscorrelate, audit=True)",
                lambda: survey_run(config, catalogs, audit=True, spans=True),
                {"paircount_partials": 1, "paircount_segment_sum": 1,
                 **dict.fromkeys(FLAG_KERNELS, 1)},
                {},
            )
        t_audit = time.perf_counter() - t0
        check(plain_calls[0] == 0, "survey audit: the plain flag pass ran on the card")
        audits = paircount.AUDIT_STATS
        check(len(audits) == stats["num_block_pairs"] == launches["boundary_flags"],
              "survey audit: not one flag pass per block pair")
        check_nz(nz, "survey audit", SURVEY_PATCHES)
        log(f"[{card}] survey audit ({stats['num_block_pairs']} block pairs, "
            f"{stats['candidate_pairs']} candidate pairs): warm unaudited "
            f"{t_plain:.2f} s, audited {t_audit:.2f} s under a host profiler; "
            f"{len(audits)} flag "
            f"passes, {stats['audit_flag']:.3f} s of host (span audit.flag); "
            f"{sum(len(a['flagged_slots']) for a in audits)} block-pair slots "
            f"recounted in {stats['audit_recount']:.2f} s of float64 on "
            f"{max(a['recount_workers'] for a in audits)} threads")
        links = PatchLinkage.from_catalogs(config, *catalogs)
        for name, count in (("DD", "cross DD"), ("RD", "cross RD")):
            _, _, pairs = engine_inputs(links, catalogs, count)
            ours = main_path_counts(getattr(audited, name.lower()), pairs, False)
            before = main_path_counts(getattr(plain, name.lower()), pairs, False)
            moved = np.abs(ours - before).max(axis=1)
            slots = np.union1d(
                np.argsort(moved)[-4:],
                np.linspace(0, pairs.num_slots - 1, 12).astype(int),
            )
            _, oracle, _, t_oracle = oracle_counts(links, catalogs, count, slots)
            expected = links.edges.counts_to_scales(oracle)[0]
            scale = np.abs(expected).max()
            err = np.abs(ours[slots] - expected).max() / scale
            err_before = np.abs(before[slots] - expected).max() / scale
            log(f"[{card}] survey audit {name}: {int(np.sum(moved > 0))} of "
                f"{pairs.num_slots} patch-pair slots moved by the audit (largest "
                f"{moved.max():.6g}); on {len(slots)} slots (the 4 moved most "
                f"and 12 evenly spaced) vs float64 oracle ({t_oracle:.1f} s): "
                f"max|err|/max|oracle| {err:.3e} (unaudited {err_before:.3e}), "
                f"per element max rel {slot_relative_error(ours[slots], expected):.3e}"
                f" (unaudited {slot_relative_error(before[slots], expected):.3e})")
            check(err <= RTOL, f"survey audit {name}: off the oracle")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def survey_checks(card, config, launches_total, root) -> None:
    import numpy as np
    import torch

    from yet_another_wizz_tpu_torch.catalog import Catalog
    from yet_another_wizz_tpu_torch.correlation import blocked
    from yet_another_wizz_tpu_torch.correlation.measurements import (
        PatchLinkage,
        crosscorrelate,
    )

    t0 = time.perf_counter()
    write_survey_caches(root)
    log(f"[{card}] survey cold setup (1M + 2M mock rows, 4M HEALPix randoms, "
        f"{SURVEY_PATCHES} kmeans patches, caches written): "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    catalogs = tuple(Catalog(os.path.join(root, name)) for name in SURVEY_NAMES)
    num_rows = sum(len(catalog.ra) for catalog in catalogs)
    log(f"survey caches opened as Catalog: {time.perf_counter() - t0:.2f} s, "
        f"{num_rows} rows")

    (first, nz, stats), launches = run_path(
        "survey (blocked crosscorrelate, tile store empty)",
        lambda: survey_run(config, catalogs),
        {"paircount_partials": 1, "paircount_segment_sum": 1},
        launches_total,
    )
    log(f"survey first run: {format_stats(stats)}")
    check(
        launches.get("paircount_partials") == stats["num_block_pairs"]
        == launches.get("paircount_segment_sum"),
        f"survey: launches {launches} differ from the {stats['num_block_pairs']} "
        "block pairs of the loop",
    )
    check(stats["store_misses"] > 0 and stats["store_hits"] == 0,
          "survey: the first run found a warm tile store")
    check_nz(nz, "survey", SURVEY_PATCHES)

    (memory,) = crosscorrelate(
        config, catalogs[0], catalogs[1], ref_rand=catalogs[2], device="cuda"
    )
    for name in ("dd", "rd"):
        ours = getattr(first, name).counts.counts
        expected = getattr(memory, name).counts.counts
        err = np.abs(ours - expected).max() / np.abs(expected).max()
        log(f"survey {name.upper()} blocked vs in-memory path: patch-pair "
            f"max|err|/max {err:.3e}")
        check(err <= RTOL, f"survey {name.upper()}: blocked off the in-memory path")
    del memory

    links = PatchLinkage.from_catalogs(config, *catalogs)
    for name, count in (("DD", "cross DD"), ("RD", "cross RD")):
        _, _, pairs = engine_inputs(links, catalogs, count)
        slots = np.linspace(0, pairs.num_slots - 1, SURVEY_ORACLE_SLOTS).astype(int)
        _, oracle, pairs, t_oracle = oracle_counts(links, catalogs, count, slots)
        oracle_scale = links.edges.counts_to_scales(oracle)[0]
        ours = main_path_counts(getattr(first, name.lower()), pairs, False)[slots]
        err = np.abs(ours - oracle_scale).max() / np.abs(oracle_scale).max()
        log(f"survey {name} vs float64 oracle ({SURVEY_ORACLE_SLOTS} of "
            f"{pairs.num_slots} slots, {t_oracle:.1f} s): per-slot "
            f"max|err|/max|oracle| {err:.3e}")
        check(err <= RTOL, f"survey {name} off the oracle")
    for catalog in catalogs:
        catalog.drop_tile_cache()
    torch.cuda.empty_cache()

    mesh = sharded_mesh()
    log(f"-- survey, sharded: blocked crosscorrelate under ring on {mesh}")
    for run in range(2):
        t0 = time.perf_counter()
        (wsp, nz, stats), launches = run_path(
            f"survey sharded (ring, {mesh.size} shards) run {run}",
            lambda: survey_run(config, catalogs, mesh=mesh, data_sharding="ring"),
            {"paircount_partials": 1, "paircount_segment_sum": 1},
            launches_total,
        )
        seconds = time.perf_counter() - t0
        err = corr_error(wsp, first, ("dd", "rd"))
        check(err <= RTOL, f"survey sharded: off the single-device survey ({err:.3e})")
        check(launches.get("paircount_partials") == launches.get("paircount_segment_sum"),
              f"survey sharded: launches {launches}")
        if run == 0:
            sharded_first = wsp
        check(same_counts(wsp, sharded_first), "survey sharded: two runs differ")
        check_nz(nz, "survey sharded", SURVEY_PATCHES)
        log(f"[{card}] survey sharded (ring, {mesh.size} shards) run {run}: "
            f"{seconds:.3f} s, {launches.get('paircount_partials')} kernel A + "
            f"{launches.get('paircount_segment_sum')} kernel B launches over "
            f"{stats['num_block_pairs']} block pairs; counts vs single device "
            f"max|err|/max {err:.3e}; {format_stats(stats)}")
    del wsp, sharded_first

    log("-- survey: warm runs (tile store hits), each in a tile cache of its own")
    torch.cuda.reset_peak_memory_stats()
    times = []
    for run in range(SURVEY_WARM_RUNS):
        t0 = time.perf_counter()
        wsp, nz, stats = survey_run(config, catalogs)
        times.append(time.perf_counter() - t0)
        log(f"[{card}] survey warm run {run}: {times[-1]:.3f} s; {format_stats(stats)}")
        check(same_counts(wsp, first), "survey: a store-hit run differs from the first run")
        check(stats["store_misses"] == 0, "survey: a warm run missed the tile store")
    warm = statistics.median(times)
    candidates = stats["candidate_pairs"]
    log(f"[{card}] survey warm: {warm:.3f} s (median of {SURVEY_WARM_RUNS}) "
        f"[{min(times):.3f}, {max(times):.3f}], {candidates:.4e} candidate pairs "
        f"-> {candidates / warm:.4e} pairs/s; store-hit runs bitwise equal to "
        f"the first; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    # the engine's kernel time: the block pairs of one run, replayed on
    # their resident inputs and timed with CUDA events
    calls = []
    engine = blocked.count_pairs_tiles

    def capturing(*args, **kwargs):
        calls.append((args, kwargs))
        return engine(*args, **kwargs)

    blocked.count_pairs_tiles = capturing
    try:
        survey_run(config, catalogs)
    finally:
        blocked.count_pairs_tiles = engine

    def replay():
        for args, kwargs in calls:
            engine(*args, **kwargs)

    engine_ms = cuda_ms(replay, 3)
    del calls
    t0 = time.perf_counter()
    _, _, phased = survey_run(config, catalogs, spans=True)
    seconds = time.perf_counter() - t0
    host_s = sum(phased[key] for key in ("rows", "cols", "pairs", "queue"))
    log(f"[{card}] survey engine kernels {engine_ms:.3f} ms over "
        f"{phased['num_block_pairs']} block pairs (replayed, CUDA events) of "
        f"the {warm * 1e3:.1f} ms warm run: idle share "
        f"~{1 - engine_ms / (warm * 1e3):.3f}; a warm run under a host "
        f"profiler ({seconds:.3f} s): drain wait "
        f"{phased['drain_wait'] * 1e3:.1f} ms, queue {phased['queue'] * 1e3:.1f} ms, "
        f"host phases (rows+cols+pairs+queue) {host_s * 1e3:.1f} ms; "
        f"{format_stats(phased)}")

    log("-- survey: a run without the tile store (YAWT_TILE_STORE=0): every block packed and uploaded")
    os.environ["YAWT_TILE_STORE"] = "0"
    try:
        t0 = time.perf_counter()
        wsp, _, stats = survey_run(config, catalogs)
        seconds = time.perf_counter() - t0
    finally:
        del os.environ["YAWT_TILE_STORE"]
    check(same_counts(wsp, first), "survey: the run without the store differs")
    rate = stats["upload_bytes"] / max(stats["upload"], 1e-12)
    log(f"[{card}] survey without the tile store: {seconds:.3f} s; uploads "
        f"{stats['upload_bytes'] / 1e6:.1f} MB in {stats['upload'] * 1e3:.2f} ms "
        f"on the card ({rate / 1e9:.2f} GB/s from pinned memory) against "
        f"{engine_ms:.2f} ms of engine kernels; {format_stats(stats)}")

    survey_budgets(card, config, catalogs, first)
    survey_hist(card, config, catalogs, root)

    log("-- survey: child processes on the same caches (tile store warm)")
    for kind in ("catalog", "lazy"):
        out = os.path.join(root, f"{kind}.npz")
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--survey-child", kind,
             root, out],
            capture_output=True, text=True, timeout=600, check=False,
        )
        check(done.returncode == 0,
              f"survey child '{kind}' failed:\n{done.stdout[-3000:]}\n"
              f"{done.stderr[-3000:]}")
        report = json.loads(done.stdout.strip().splitlines()[-1])
        counts = np.load(out)
        check(
            np.array_equal(counts["dd"], first.dd.counts.counts)
            and np.array_equal(counts["rd"], first.rd.counts.counts),
            f"survey: the {kind} child's counts differ from the first run",
        )
        # anonymous memory where the kernel reports it, else all of it
        main = "RssAnon" if "RssAnon" in report["base"] else "VmRSS"
        base, opened, peak = (report[key] for key in ("base", "opened", "peak"))
        others = ", ".join(
            f"{key} {base[key] / 2**30:.3f} -> {peak[key] / 2**30:.3f} GiB"
            for key in MEMORY_KINDS if key != main and key in base
        )
        log(f"[{card}] survey child {kind}: open {report['open_s']:.2f} s, open + "
            f"run {report['total_s']:.2f} s; host memory {main} "
            f"{base[main] / 2**30:.3f} GiB before opening, "
            f"{opened[main] / 2**30:.3f} after, {peak[main] / 2**30:.3f} at the "
            f"peak of the run: {(peak[main] - base[main]) / report['rows']:.1f} "
            f"B/row over {report['rows']} rows ({others}); process peak RSS "
            f"{report['max_rss'] / 2**30:.3f} GiB; bitwise equal to the first "
            f"run; {format_stats(report['stats'])}")


# -- the batch pipeline (the command line over the tomographic task graph) ----


CLI_BINS = 4
"""Tomographic bins of the unknown sample, split by quantiles of its true
redshift (the JAX package's ``scripts/tomo_pipeline_proof.py`` default)."""
CLI_TASKS = ["auto_ref", "cross_corr", "estimate", "hist", "plot"]
CLI_RESIDENT = 24
CLI_ORACLE_SLOTS = 48
CLI_DEVICE = "cuda"
CLI_CARD = "cuda:0"
"""The device every launch of the phase must name (one card)."""
CLI_SIZES = dict(
    num_reference=NUM_REFERENCE, num_unknown=NUM_UNKNOWN, num_randoms=NUM_RANDOMS
)
CLI_PATCHES = NUM_PATCHES
CLI_KERNELS = {
    "paircount_partials": "paircount_partials_kernel",
    "paircount_partials_binned": "paircount_partials_kernel",
    "paircount_segment_sum": "segment_sum_kernel",
}
"""The launch counts the phase's runs must raise (K1.1 from ``cross_corr``,
K1.2 from ``auto_ref``, kernel B after each), by the kernel's name in a
profiler trace."""


def write_cli_inputs(root: str) -> dict:
    """The benchmark's mock catalogs as FITS files (RA and DEC in degrees,
    Z and W; written by ``tests/torch_cli_cases.py::write_fits``): the
    reference, its randoms, and the unknown sample split into
    :data:`CLI_BINS` tomographic bins by quantiles of its true redshift."""
    import numpy as np

    from yet_another_wizz_tpu_torch.examples import generate_mock_data

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_cli_cases import write_fits

    mock = generate_mock_data(**CLI_SIZES, seed=SEED)

    def table(sample, select=slice(None)):
        return dict(
            RA=np.rad2deg(sample["ra"][select]), DEC=np.rad2deg(sample["dec"][select]),
            Z=sample["redshifts"][select], W=sample["weights"][select],
        )

    paths = {name: os.path.join(root, f"{name}.fits") for name in ("reference", "randoms")}
    write_fits(paths["reference"], table(mock["reference"]))
    write_fits(paths["randoms"], table(mock["randoms"]))
    redshifts = mock["unknown"]["redshifts"]
    cuts = np.quantile(redshifts, np.linspace(0.0, 1.0, CLI_BINS + 1))
    cuts[0], cuts[-1] = -np.inf, np.inf
    paths["unknown"] = {}
    for index in range(1, CLI_BINS + 1):
        select = (redshifts > cuts[index - 1]) & (redshifts <= cuts[index])
        paths["unknown"][index] = os.path.join(root, f"unknown_{index}.fits")
        write_fits(paths["unknown"][index], table(mock["unknown"], select))
    return paths


def cli_setup(paths: dict, execution: dict) -> dict:
    """The phase's setup, in the JAX package's schema."""
    columns = dict(ra="RA", dec="DEC", redshift="Z", weight="W")
    return dict(
        correlation=dict(
            scales=dict(rmin=CONFIG["rmin"], rmax=CONFIG["rmax"], unit=CONFIG["unit"]),
            binning=dict(zmin=ZRANGE["zmin"], zmax=ZRANGE["zmax"],
                         num_bins=ZRANGE["num_bins"]),
        ),
        inputs=dict(
            reference=dict(path_data=paths["reference"], path_rand=paths["randoms"],
                           **columns),
            unknown=dict(path_data=dict(paths["unknown"]), **columns),
            num_patches=CLI_PATCHES,
        ),
        execution=dict(execution),
        tasks=list(CLI_TASKS),
    )


TASK_LINE = re.compile(r"task '(\w+)' finished after (\d+)m(\d+\.\d+)s")


def task_seconds(log_text: str) -> dict:
    """Seconds of each task from a project log's CLIENT lines."""
    return {
        name: int(minutes) * 60 + float(seconds)
        for name, minutes, seconds in TASK_LINE.findall(log_text)
    }


def trace_kernel_times(path: str) -> tuple[dict, float]:
    """Launches and milliseconds of each CUDA kernel in a Chrome trace of
    ``torch.profiler``, by name, and the span of the trace in ms."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if "dur" in e and "ts" in e]
    kernels: dict = {}
    for event in events:
        if event.get("cat") == "kernel":
            count, ms = kernels.get(event["name"], (0, 0.0))
            kernels[event["name"]] = (count + 1, ms + event["dur"] / 1e3)
    span = (max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)) / 1e3
    return kernels, span


def cli_run(label: str, argv: list, *, tile_caches: list | None = None) -> dict:
    """One run of the command line (``commandline.main``) with the launch
    counts set to 0 just before it: its launches, the devices of the
    launches and of any plain-engine call, its seconds, peak device and
    host memory, and the tile caches its blocked measurements opened."""
    import torch

    from yet_another_wizz_tpu_torch.cli.commandline import main as cli_main
    from yet_another_wizz_tpu_torch.correlation import blocked
    from yet_another_wizz_tpu_torch.utils import tracing

    original = blocked.measurement_tile_cache

    def recording(*args, **kwargs):
        context = original(*args, **kwargs)

        class Recorder:
            def __enter__(self):
                cache = context.__enter__()
                if tile_caches is not None:
                    tile_caches.append(cache)
                return cache

            def __exit__(self, *exc):
                return context.__exit__(*exc)

        return Recorder()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    blocked.measurement_tile_cache = recording
    try:
        with EngineSpy() as spy, MemorySampler() as memory:
            base = host_memory()["VmRSS"]
            tracing.reset()
            t0 = time.perf_counter()
            code = cli_main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = counted_launches()
    finally:
        blocked.measurement_tile_cache = original
    check(code == 0, f"cli {label}: the command line exited with {code}")
    check(not spy.plain_devices - {"cpu"},
          f"cli {label}: the plain engine ran on {sorted(spy.plain_devices)}")
    check(spy.kernel_devices <= {CLI_CARD},
          f"cli {label}: kernels launched on {sorted(spy.kernel_devices)}")
    return dict(
        launches=launches, seconds=seconds, devices=sorted(spy.kernel_devices),
        device_peak=torch.cuda.max_memory_allocated(),
        host_peak=memory.peak["VmRSS"], host_base=base,
    )


def counts_of(corr) -> dict:
    """Pair counts and weight sums of every count type of a CorrFunc."""
    import numpy as np

    return {
        name: (np.asarray(counts.counts.get_array()),
               np.asarray(counts.sum_weights.get_array()))
        for name in ("dd", "dr", "rd", "rr")
        if (counts := getattr(corr, name)) is not None
    }


def same_count_arrays(ours: dict, theirs: dict) -> bool:
    import numpy as np

    return set(ours) == set(theirs) and all(
        np.array_equal(ours[k][0], theirs[k][0]) and np.array_equal(ours[k][1], theirs[k][1])
        for k in ours
    )


def relative_count_error(ours: dict, theirs: dict) -> float:
    import numpy as np

    check(set(ours) == set(theirs), "cli: count types differ")
    return max(
        float(np.abs(ours[k][0] - theirs[k][0]).max() / np.abs(theirs[k][0]).max())
        for k in ours
    )


def cli_api_checks(card, project: str) -> dict:
    """Run A's products against the API called on the project's own caches
    (``Catalog(cache)``, on the card): pair counts bit for bit, the
    estimates' and histograms' files byte for byte; bin 1's cross DD on its
    first slots against the float64 oracle. Returns the API's CorrFuncs."""
    import tempfile

    import numpy as np

    from yet_another_wizz_tpu_torch.catalog import Catalog
    from yet_another_wizz_tpu_torch.cli.config import ProjectConfig
    from yet_another_wizz_tpu_torch.correlation import load_corrfunc
    from yet_another_wizz_tpu_torch.correlation.measurements import (
        PatchLinkage,
        autocorrelate,
        crosscorrelate,
    )
    from yet_another_wizz_tpu_torch.redshifts import HistData, RedshiftData

    config = ProjectConfig.from_file(os.path.join(project, "pipeline.yml")).correlation
    cache = os.path.join(project, "cache")
    reference = Catalog(os.path.join(cache, "reference", "data"))
    ref_rand = Catalog(os.path.join(cache, "reference", "rand"))
    t0 = time.perf_counter()
    api = {"auto_ref": autocorrelate(config, reference, ref_rand, device=CLI_DEVICE)[0]}
    unknowns = {}
    for index in range(1, CLI_BINS + 1):
        unknowns[index] = Catalog(os.path.join(cache, f"unknown_{index}", "data"))
        api[f"cross_{index}"] = crosscorrelate(
            config, reference, unknowns[index], ref_rand=ref_rand, device=CLI_DEVICE
        )[0]
    api_seconds = time.perf_counter() - t0
    for name, corr in api.items():
        stored = load_corrfunc(os.path.join(project, "paircounts", f"{name}.hdf"))
        check(same_count_arrays(counts_of(stored), counts_of(corr)),
              f"cli: paircounts/{name}.hdf is not the API's counts")

    compared = 0
    with tempfile.TemporaryDirectory(prefix="yawt_cli_api_") as tmp:
        sample = dict(method="jackknife", num_samples=None, estimator=None)
        auto_data = api["auto_ref"].sample(**sample)
        outputs = {"estimate/auto_ref": auto_data}
        for index, unknown in unknowns.items():
            cross_data = api[f"cross_{index}"].sample(**sample)
            outputs[f"estimate/cross_{index}"] = cross_data
            outputs[f"estimate/nz_est_{index}"] = RedshiftData.from_corrdata(
                cross_data, auto_data, None
            )
            outputs[f"true/nz_true_{index}"] = HistData.from_catalog(unknown, config)
        for name, data in outputs.items():
            prefix = os.path.join(tmp, name.replace("/", "_"))
            data.to_files(prefix)
            for suffix in (".dat", ".smp", ".cov"):
                with open(prefix + suffix, "rb") as ours, open(
                    os.path.join(project, name + suffix), "rb"
                ) as theirs:
                    check(ours.read() == theirs.read(),
                          f"cli: {name}{suffix} is not the API's file")
                compared += 1

    catalogs = (reference, unknowns[1], ref_rand)
    links = PatchLinkage.from_catalogs(config, *catalogs)
    slots = np.arange(CLI_ORACLE_SLOTS)
    _, oracle, pairs, t_oracle = oracle_counts(links, catalogs, "cross DD", slots)
    oracle_scale = links.edges.counts_to_scales(oracle)[0]
    ours = main_path_counts(api["cross_1"].dd, pairs, False)[slots]
    err = np.abs(ours - oracle_scale).max() / np.abs(oracle_scale).max()
    log(f"[{card}] cli A: {len(api)} pair-count files bitwise the API's on the "
        f"project's caches ({api_seconds:.2f} s of API calls), {compared} "
        f"estimate and histogram files byte for byte; bin 1 cross DD on "
        f"{CLI_ORACLE_SLOTS} slots vs the float64 oracle ({t_oracle:.1f} s): "
        f"max|err|/max {err:.3e}")
    check(err <= RTOL, "cli: bin 1 cross DD off the float64 oracle")
    return api


def report_run(card: str, label: str, run: dict, project: str) -> None:
    """One line per run: seconds, per-task seconds from the project log,
    launches and their devices, peak device and host memory."""
    with open(os.path.join(project, "pipeline.log")) as f:
        seconds = task_seconds(f.read())
    tasks = ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items())
    log(f"[{card}] cli {label}: {run['seconds']:.2f} s through main(), tasks {tasks}; "
        f"launches {run['launches']} on {run['devices']}; peak device memory "
        f"{run['device_peak'] / 2**20:.1f} MiB; host VmRSS {run['host_base'] / 2**30:.3f}"
        f" -> {run['host_peak'] / 2**30:.3f} GiB at the peak")


def cli_phase(card: str, launches_total: dict) -> None:
    """The pipeline's tomographic task graph through its command line
    (``python -m yet_another_wizz_tpu_torch.cli``'s ``main``) on the card,
    at the benchmark's size: runs A (in memory), B (blocked, lazy
    catalogs), C (``--resume`` of A) and D (``--profile`` of A's counting
    tasks on a copy of A's project), with the checks of each."""
    import importlib.util
    import shutil
    import tempfile

    import numpy as np
    import yaml

    log(f"[{card}] packages: " + ", ".join(
        f"{name} {'present' if importlib.util.find_spec(name) else 'absent'}"
        for name in ("yaml", "h5py", "matplotlib", "pyarrow")
    ))
    log(f"cli: pair counts are stored through {ensure_h5py()}")
    from yet_another_wizz_tpu_torch.correlation import load_corrfunc
    from yet_another_wizz_tpu_torch.redshifts import RedshiftData
    from yet_another_wizz_tpu_torch.utils.plotting import PLOTTING_ENABLED

    root = tempfile.mkdtemp(prefix="yawt_cli_")
    try:
        t0 = time.perf_counter()
        paths = write_cli_inputs(root)
        size = sum(os.path.getsize(p) for p in (
            paths["reference"], paths["randoms"], *paths["unknown"].values()))
        log(f"cli inputs: {size / 1e6:.1f} MB of FITS in "
            f"{time.perf_counter() - t0:.2f} s ({CLI_BINS} tomographic bins)")
        setups, projects = {}, {}
        for label, execution in (
            ("A", {}), ("B", dict(max_resident_patches=CLI_RESIDENT, lazy=True))
        ):
            setups[label] = os.path.join(root, f"setup_{label}.yml")
            with open(setups[label], "w") as f:
                yaml.safe_dump(cli_setup(paths, execution), f)
            projects[label] = os.path.join(root, f"project_{label}")
        runs = {}

        log("-- cli A: in memory")
        runs["A"] = cli_run("A", [projects["A"], setups["A"], "--device", CLI_DEVICE,
                                  "--quiet"])
        report_run(card, "A", runs["A"], projects["A"])
        cli_api_checks(card, projects["A"])

        log(f"-- cli B: blocked (max_resident_patches {CLI_RESIDENT}), lazy catalogs")
        caches: list = []
        runs["B"] = cli_run("B", [projects["B"], setups["B"], "--device", CLI_DEVICE,
                                  "--quiet"], tile_caches=caches)
        report_run(card, "B", runs["B"], projects["B"])
        check(len(caches) == 1, f"cli B: {len(caches)} session tile caches, not one")
        log(f"[{card}] cli B: session tile cache {caches[0].hits} hits, "
            f"{caches[0].misses} rebuilds")
        check(caches[0].hits > 0, "cli B: the session tile cache was never hit")
        names = ["auto_ref", *(f"cross_{i}" for i in range(1, CLI_BINS + 1))]
        counts_err = max(relative_count_error(
            counts_of(load_corrfunc(os.path.join(projects["B"], "paircounts", f"{n}.hdf"))),
            counts_of(load_corrfunc(os.path.join(projects["A"], "paircounts", f"{n}.hdf"))),
        ) for n in names)
        nz_err = 0.0
        for index in range(1, CLI_BINS + 1):
            a, b = (RedshiftData.from_files(os.path.join(
                projects[k], "estimate", f"nz_est_{index}")) for k in "AB")
            for field in ("data", "samples", "covariance"):
                desired = getattr(a, field)
                nz_err = max(nz_err, float(
                    np.abs(getattr(b, field) - desired).max() / np.abs(desired).max()))
            for suffix in (".dat", ".smp", ".cov"):
                name = os.path.join("true", f"nz_true_{index}{suffix}")
                with open(os.path.join(projects["A"], name), "rb") as fa, open(
                    os.path.join(projects["B"], name), "rb"
                ) as fb:
                    check(fa.read() == fb.read(), f"cli B: {name} differs from A's")
        log(f"[{card}] cli B vs A: counts max|err|/max {counts_err:.3e}, n(z) "
            f"{nz_err:.3e}, histograms bitwise")
        check(counts_err <= RTOL, "cli B: counts off the in-memory run")
        check(nz_err <= RTOL, "cli B: n(z) off the in-memory run")

        log("-- cli C: --resume of A")
        runs["C"] = cli_run("C", [projects["A"], "--resume", "--device", CLI_DEVICE,
                                  "--quiet"])
        with open(os.path.join(projects["A"], "pipeline.log")) as f:
            last = f.read().rsplit("running 1 task(s)", 1)
        check(len(last) == 2 and re.findall(r"running task '(\w+)'", last[1]) == ["plot"],
              "cli C: the resumed run did not skip every task but 'plot'")
        check(not runs["C"]["launches"], f"cli C: launches {runs['C']['launches']}")
        log(f"[{card}] cli C: {runs['C']['seconds']:.2f} s, every task skipped but "
            "'plot' (regenerated on every run, as in the JAX package), no launch")

        log("-- cli D: --profile, A's counting tasks again on a copy of its project")
        projects["D"] = os.path.join(root, "project_D")
        shutil.copytree(projects["A"], projects["D"], symlinks=True)
        for sub in ("paircounts", "estimate", "plots"):
            shutil.rmtree(os.path.join(projects["D"], sub), ignore_errors=True)
        runs["D"] = cli_run("D", [projects["D"], "--resume", "--profile", "--device",
                                  CLI_DEVICE, "--quiet"])
        for name in names:
            check(same_count_arrays(
                counts_of(load_corrfunc(os.path.join(projects["D"], "paircounts", f"{name}.hdf"))),
                counts_of(load_corrfunc(os.path.join(projects["A"], "paircounts", f"{name}.hdf"))),
            ), f"cli D: {name} differs from A's")
        kernels, span = trace_kernel_times(
            os.path.join(projects["D"], "profile", "trace.json"))
        busy = sum(ms for _, ms in kernels.values())
        for launch_name, kernel in CLI_KERNELS.items():
            traced = sum(n for name, (n, _) in kernels.items() if kernel in name)
            check(traced > 0, f"cli D: no {kernel} in the profiler trace")
        for kernel in sorted(set(CLI_KERNELS.values())):
            n = sum(c for name, (c, _) in kernels.items() if kernel in name)
            ms = sum(t for name, (_, t) in kernels.items() if kernel in name)
            log(f"[{card}] cli D trace: {kernel} {n} launches, {ms:.3f} ms")
        log(f"[{card}] cli D: {runs['D']['seconds']:.2f} s profiled, launches "
            f"{runs['D']['launches']}; counts bitwise A's; the trace spans "
            f"{span:.1f} ms with {busy:.3f} ms of kernels ({len(kernels)} kernel "
            f"names): the card is busy {100 * busy / span:.2f} % of it")

        for label in ("A", "B", "D"):
            launches = runs[label]["launches"]
            for name in CLI_KERNELS:
                check(launches.get(name, 0) > 0, f"cli {label}: {name} never launched")
            for name, count in launches.items():
                launches_total[name] = launches_total.get(name, 0) + count
        log(f"[{card}] cli launches per run: " + "; ".join(
            f"{k} {runs[k]['launches'] or 'none'}" for k in "ABCD"))
        plots = sorted(os.listdir(os.path.join(projects["A"], "plots"))) if os.path.isdir(
            os.path.join(projects["A"], "plots")) else []
        if PLOTTING_ENABLED:
            check(plots == ["auto_ref.png", "nz_estimate.png"], f"cli A: plots {plots}")
            log(f"[{card}] cli plots written: {', '.join(plots)}")
        else:
            check(not plots, "cli A: plots without matplotlib")
            log(f"[{card}] cli plots: matplotlib absent, the plot task logged a "
                "warning and skipped")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# -- the survey-scale proofs at a reduced size --------------------------------


PROOF_SURVEY_ARGS = [
    "--rows", "4000000", "--patches", "128", "--resident", "24", "--downsample", "16",
    "--ingest-chunk", "400000", "--parquet-chunk", "200000",
]
"""``scripts/torch_survey_proof.py`` at a tenth of its rows: 128 patches, 24
resident, the 40M-row run's ingestion chunk and row group cut in the same
proportion, so every catalog takes as many reader rounds (2, 4 and 5)."""
PROOF_TOMO_ARGS = [
    "--rows", "1000000", "--bins", "4", "--patches", "96", "--resident", "24",
    "--downsample", "8",
]
"""``scripts/torch_tomo_pipeline_proof.py`` at 1M rows: 4 bins, 96 patches,
24 resident, lazy catalogs; the downsample keeps every eighth row."""
PROOF_TIMEOUT = 450


def run_proof(name: str, script: str, args: list, root: str) -> dict:
    """One proof script in a subprocess, on the card; its record (written
    only when every gate of the script passed)."""
    out = os.path.join(root, f"{name}.json")
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                      "scripts", script),
         *args, "--device", "cuda", "--workdir", os.path.join(root, name), "--out", out],
        capture_output=True, text=True, timeout=PROOF_TIMEOUT, check=False,
    )
    seconds = time.perf_counter() - t0
    check(done.returncode == 0 and os.path.exists(out),
          f"proof {name} failed ({done.returncode}):\n{done.stderr[-4000:]}")
    with open(out) as f:
        record = json.load(f)
    record["script_s"] = seconds
    return record


def proof_phase(card: str, launches_total: dict) -> None:
    """Both survey-scale proofs (``scripts/torch_survey_proof.py``,
    ``scripts/torch_tomo_pipeline_proof.py``) at a reduced size, each in a
    subprocess on the card: every gate of each script, and besides that
    their kernels launched (K1.1 and kernel B once per block pair of the
    survey; K1.1, K1.2 and kernel B in both pipeline runs), the plain
    engine never ran on the card, and every survey catalog took at least
    two reader rounds."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="yawt_proofs_")
    try:
        survey = run_proof("survey", "torch_survey_proof.py", PROOF_SURVEY_ARGS, root)
        prep, meas, cross = survey["prepare"], survey["measure"], survey["crosscheck"]
        rounds = {k: v["rounds"] for k, v in prep["ingestion_rounds"].items()}
        check(min(rounds.values()) >= 2, f"proof survey: reader rounds {rounds}")
        check(cross["oracle_max_rel_err"] < RTOL and meas["nz_finite"]
              and survey["nz_full_vs_downsample_chi2"] < 3.0,
              "proof survey: a gate of the script does not hold in its record")
        check((meas["num_patches"], meas["max_resident_patches"]) == (128, 24),
              "proof survey: not 128 patches with 24 resident")
        blocks = meas["num_block_pairs"]
        check(meas["launches"].get("paircount_partials") == blocks
              == meas["launches"].get("paircount_segment_sum") and blocks > 0,
              f"proof survey: launches {meas['launches']} against {blocks} block pairs")
        check(not [d for d in meas["plain_engine_devices"] + cross["plain_engine_devices"]
                   if d.startswith("cuda")], "proof survey: the plain engine ran on the card")
        warm = meas["host_memory"]["warm"]
        log(f"[{card}] proof survey ({meas['rows']} rows, {meas['num_patches']} patches, "
            f"{meas['max_resident_patches']} resident, Parquet rounds {rounds}): script "
            f"{survey['script_s']:.1f} s (generate {prep['generate_s']} s, Parquet "
            f"{prep['parquet_write_s']} s, ingest {prep['ingest_s']} s); cold "
            f"{meas['cold_wall_s']} s, warm {meas['warm_wall_s']} s over {blocks} block "
            f"pairs, {meas['candidate_pairs']:.4e} candidate pairs; engine kernels "
            f"{meas['engine_kernel_ms']} ms; launches {meas['launches']}; peak device "
            f"memory {meas['device_memory_stats']['max_memory_allocated'] / 2**20:.1f} MiB; "
            f"host VmRSS growth {warm['bytes_per_row']} B/row (warm), "
            f"{meas['host_memory']['cold']['bytes_per_row']} B/row (cold); tile store "
            f"{meas['tile_store']['stored_bytes'] / 1e6:.1f} MB, reads {meas['store_reads']}; "
            f"oracle on the 1/{cross['downsample_stride']} downsample "
            f"{cross['oracle_max_rel_err']:.3e} ({cross['oracle_s']} s), chi2 "
            f"{survey['nz_full_vs_downsample_chi2']}")

        tomo = run_proof("tomo", "torch_tomo_pipeline_proof.py", PROOF_TOMO_ARGS, root)
        check(all(b["nz_finite"] and b["peak_bin_has_true_support"]
                  for b in tomo["bins"].values())
              and tomo["mean_full_vs_downsample_chi2"] < 3.0,
              "proof tomo: a gate of the script does not hold in its record")
        for key in ("pipeline", "downsample_pipeline"):
            run = tomo[key]
            for kernel in ("paircount_partials", "paircount_partials_binned",
                           "paircount_segment_sum"):
                check(run["launches"].get(kernel, 0) > 0, f"proof tomo {key}: no {kernel}")
            check(not [d for d in run["plain_engine_devices"] if d.startswith("cuda")],
                  f"proof tomo {key}: the plain engine ran on the card")
            check(run["tile_cache"]["hits"] > 0, f"proof tomo {key}: no tile cache hit")
        run = tomo["pipeline"]
        log(f"[{card}] proof tomo ({tomo['total_rows_requested']} rows, "
            f"{tomo['num_tomographic_bins']} bins, {tomo['num_patches']} patches, "
            f"{tomo['max_resident_patches']} resident, lazy): script "
            f"{tomo['script_s']:.1f} s; full run {run['wall_s']} s, tasks "
            f"{run['task_walls_s']}, bins {run['bin_walls_s']}; launches {run['launches']}; "
            f"tile cache {run['tile_cache']}; peak device memory "
            f"{run['device_peak_bytes'] / 2**20:.1f} MiB; host VmRSS growth "
            f"{run['host_memory']['bytes_per_row']} B/row; pair counts through "
            f"{run['pair_counts_stored_through']}; mean chi2 "
            f"{tomo['mean_full_vs_downsample_chi2']}")
        for counted in (meas["launches"], tomo["pipeline"]["launches"],
                        tomo["downsample_pipeline"]["launches"]):
            for name, count in counted.items():
                launches_total[name] = launches_total.get(name, 0) + count
    finally:
        shutil.rmtree(root, ignore_errors=True)

# -- slice 12: build_trees warming the card, streaming ingestion ------------


@contextlib.contextmanager
def warm_spy():
    """Counts, while active, the tile sets built (``build_tile_set`` as the
    catalog calls it), the lane uploads (``TileSet.device_data``'s
    ``_Upload``) and the chunk caps derived (``chunk_caps`` as the kernel
    wrapper calls it)."""
    from yet_another_wizz_tpu_torch.catalog import catalog as catalog_module
    from yet_another_wizz_tpu_torch.ops import cuda_paircount, tiles

    targets = (
        (catalog_module, "build_tile_set"), (tiles, "_Upload"),
        (cuda_paircount, "chunk_caps"),
    )
    counts = dict.fromkeys((name for _, name in targets), 0)
    saved = []
    for module, name in targets:
        original = getattr(module, name)

        def counted(*args, _original=original, _name=name, **kwargs):
            counts[_name] += 1
            return _original(*args, **kwargs)

        saved.append((module, name, original))
        setattr(module, name, counted)
    try:
        yield counts
    finally:
        for module, name, original in saved:
            setattr(module, name, original)


def surface_warm(card, config, catalogs, wsp, headline_warm, launches_total) -> None:
    """``build_trees`` on the card before the headline measurement: the
    measurement after it builds no tile set, uploads no lanes and derives no
    chunk caps, runs K1.1 and kernel B as CUDA kernels and no plain engine on
    the card, and its DD and RD counts are the main path's bit for bit."""
    import numpy as np
    import torch

    from yet_another_wizz_tpu_torch.correlation.measurements import (
        PatchLinkage,
        crosscorrelate,
    )
    from yet_another_wizz_tpu_torch.utils import tracing
    from yet_another_wizz_tpu_torch.redshifts import RedshiftData

    reference, unknown, randoms = catalogs

    def measure():
        (corr,) = crosscorrelate(
            config, reference, unknown, ref_rand=randoms, device="cuda"
        )
        nz = RedshiftData.from_corrfuncs(corr)
        torch.cuda.synchronize()
        return corr, nz

    def drop_tiles():
        for catalog in catalogs:
            catalog.drop_tile_cache()
        torch.cuda.synchronize()

    drop_tiles()
    t0 = time.perf_counter()
    measure()
    cold = time.perf_counter() - t0

    drop_tiles()
    max_angle = PatchLinkage.from_catalogs(config, *catalogs).edges.max_angle
    binning = config.binning.binning
    t0 = time.perf_counter()
    for catalog in (reference, randoms):
        catalog.build_trees(
            binning.edges, closed=binning.closed, max_angle=max_angle, device="cuda"
        )
    unknown.build_trees(None, device="cuda")
    torch.cuda.synchronize()
    build = time.perf_counter() - t0
    layouts = {
        name: sorted(key[4] for key in catalog._tile_cache)
        for name, catalog in zip(CATALOG_NAMES, catalogs)
    }

    tracing.reset()
    with warm_spy() as built, EngineSpy() as engine:
        t0 = time.perf_counter()
        corr, nz = measure()
        first = time.perf_counter() - t0
    launches = counted_launches()
    log(f"surface: build_trees ({max_angle:.6e} rad, layouts {layouts}), then "
        f"crosscorrelate + n(z): built and uploaded in the measurement {built}, "
        f"launches {launches}, kernel devices {sorted(engine.kernel_devices)}, "
        f"plain engine devices {sorted(engine.plain_devices)}")
    check(not any(built.values()), f"surface: the measurement after build_trees built {built}")
    for variant in ("paircount_partials", "paircount_segment_sum"):
        check(launches.get(variant, 0) >= 2, f"surface: {variant} launched {launches}")
    check(bool(engine.kernel_devices)
          and all(d.startswith("cuda") for d in engine.kernel_devices),
          f"surface: kernel wrappers called on {engine.kernel_devices}")
    check(not any(d.startswith("cuda") for d in engine.plain_devices),
          "surface: the plain engine ran on the card")
    for name in ("dd", "rd"):
        check(np.array_equal(getattr(corr, name).counts.counts,
                             getattr(wsp, name).counts.counts),
              f"surface: {name.upper()} after build_trees differs from the main path's")
    check_nz(nz, "surface", reference.num_patches)
    for variant, count in launches.items():
        launches_total[variant] = launches_total.get(variant, 0) + count
    log(f"[{card}] surface: build_trees {build:.4f} s (reference and randoms with "
        f"max_angle, unknown unbinned); first crosscorrelate + n(z) after it "
        f"{first:.4f} s; headline warm median {headline_warm:.4f} s; cold first "
        f"measurement without build_trees {cold:.4f} s")


def surface_ingest(card, reference) -> None:
    """``RandomReader`` over ``HealPixRandoms`` (the survey's mask, nside
    and seed, the headline reference's redshifts) streamed in chunks of
    250k into a cache, with the patch assignment on the card against the
    headline reference's centers: without ``keep_data`` the function
    returns no data and the cache reads back every row; with ``keep_data``,
    from a generator of the same seed, it writes the same files byte for
    byte and returns the cache's rows. Logs the host memory each adds."""
    import filecmp
    import gc
    import shutil
    import tempfile
    import tracemalloc

    import numpy as np

    from yet_another_wizz_tpu_torch.catalog import Catalog
    from yet_another_wizz_tpu_torch.catalog.ingest import write_patches_streaming
    from yet_another_wizz_tpu_torch.catalog.readers import RandomReader
    from yet_another_wizz_tpu_torch.ops import kmeans
    from yet_another_wizz_tpu_torch.randoms import HealPixRandoms
    from yet_another_wizz_tpu_torch.utils.healpix import pix2ang_ring

    colat, lon = pix2ang_ring(SURVEY_NSIDE, np.arange(12 * SURVEY_NSIDE**2))
    ra, dec = np.rad2deg(lon), 90.0 - np.rad2deg(colat)
    mask = ((ra >= 40) & (ra <= 60) & (dec >= -10) & (dec <= 10)).astype(float)
    centers = reference.get_centers().to_3d()
    root = tempfile.mkdtemp(prefix="yawt_surface_")
    threshold = kmeans.DEVICE_ASSIGN_THRESHOLD
    kmeans.DEVICE_ASSIGN_THRESHOLD = 0  # every chunk's assignment on the card
    try:
        # the first ingestion's one-time costs (imports, the writer thread's
        # start) are paid here, outside the measured two
        write_patches_streaming(
            RandomReader(HealPixRandoms(mask, seed=1), 2 * SURFACE_BUFFERSIZE,
                         chunksize=SURFACE_BUFFERSIZE),
            os.path.join(root, "warm_up"), centers[:1], device="cuda",
        )
        runs = {}
        for keep in (False, True):
            reader = RandomReader(
                HealPixRandoms(mask, redshifts=reference.redshifts, seed=SURVEY_RANDOM_SEED),
                SURFACE_RANDOMS, chunksize=SURFACE_CHUNK,
            )
            cache = os.path.join(root, f"keep_{keep}")
            gc.collect()
            base = host_memory()
            tracemalloc.start()
            with MemorySampler() as sampler:
                t0 = time.perf_counter()
                num, assembled = write_patches_streaming(
                    reader, cache, centers, buffersize=SURFACE_BUFFERSIZE,
                    keep_data=keep, device="cuda",
                )
                seconds = time.perf_counter() - t0
            peak = tracemalloc.get_traced_memory()[1]
            tracemalloc.stop()
            rss = sampler.peak["VmRSS"] - base["VmRSS"]
            runs[keep] = (num, assembled, cache)
            log(f"[{card}] surface ingest keep_data={keep}: {SURFACE_RANDOMS} rows in "
                f"chunks of {SURFACE_CHUNK}, buffersize {SURFACE_BUFFERSIZE}, {num} "
                f"patches, {seconds:.3f} s; host memory added: tracemalloc peak "
                f"{peak / 2**20:.1f} MiB, VmRSS peak growth {rss / 2**20:.1f} MiB")
        num, assembled, streamed = runs[False]
        check(assembled is None, "surface ingest: keep_data=False returned data")
        check(num == NUM_PATCHES, f"surface ingest: {num} patches")
        catalog = Catalog(streamed)
        check(sum(catalog.get_num_records()) == SURFACE_RANDOMS,
              "surface ingest: the cache does not read back every row")
        kept_num, (chunk, patch_ids), kept = runs[True]
        check(kept_num == num, "surface ingest: keep_data=True has other patches")
        names = sorted(
            os.path.relpath(os.path.join(d, f), streamed)
            for d, _, files in os.walk(streamed) for f in files
        )
        check(len(names) == 2 * NUM_PATCHES + 1, f"surface ingest: files {len(names)}")
        for name in names:
            check(filecmp.cmp(os.path.join(streamed, name), os.path.join(kept, name),
                              shallow=False),
                  f"surface ingest: {name} differs between keep_data=False and True")
        for field in chunk.dtype.names:
            check(np.array_equal(chunk[field], getattr(catalog, field)),
                  f"surface ingest: returned {field} differs from the cache's")
        check(np.array_equal(patch_ids, catalog.patch_ids),
              "surface ingest: returned patch ids differ from the cache's")
        log(f"surface ingest: {len(names)} files byte-identical, returned rows "
            f"equal the cache's ({sorted(chunk.dtype.names)})")
    finally:
        kmeans.DEVICE_ASSIGN_THRESHOLD = threshold
        shutil.rmtree(root, ignore_errors=True)


def surface_phase(card, config, catalogs, wsp, headline_warm, launches_total) -> None:
    """Slice 12 at the headline's size: :func:`surface_warm`, then
    :func:`surface_ingest`."""
    t0 = time.perf_counter()
    surface_warm(card, config, catalogs, wsp, headline_warm, launches_total)
    surface_ingest(card, catalogs[0])
    log(f"[{card}] surface phase {time.perf_counter() - t0:.1f} s")


def main() -> None:
    card = environment()
    # every phase but the sharded ones counts on one card: pin the automatic
    # device pool, which would spread them over a machine's cards
    os.environ["YAWT_NUM_DEVICES"] = "1"

    import numpy as np
    import torch

    from yet_another_wizz_tpu_torch.config import Configuration
    from yet_another_wizz_tpu_torch.correlation.measurements import (
        PatchLinkage,
        autocorrelate,
        autocorrelate_scalar,
        crosscorrelate,
        crosscorrelate_scalar,
    )
    from yet_another_wizz_tpu_torch.ops.paircount import count_pairs_tiles
    from yet_another_wizz_tpu_torch.redshifts import RedshiftData

    t_start = time.perf_counter()
    build_kernels()
    configs = {
        "headline": Configuration.create(**CONFIG),
        "B": Configuration.create(**CONFIG_B),
        "wide": Configuration.create(**CONFIG_WIDE),
        "many": Configuration.create(**CONFIG_MANY),
    }
    config = configs["headline"]

    log("-- kernels vs plain versions on the card (inputs of each path)")
    catalogs, _ = make_catalogs()
    kernel_results = kernels_vs_plain(card, catalogs, configs)
    del catalogs

    log("-- main path")
    launches_total: dict[str, int] = {}
    torch.cuda.reset_peak_memory_stats()
    t_path = time.perf_counter()
    catalogs, stages = make_catalogs()
    reference, unknown, randoms = catalogs
    t0 = time.perf_counter()
    (wsp,), launches = run_path(
        "main (crosscorrelate)",
        lambda: crosscorrelate(
            config, reference, unknown, ref_rand=randoms, device="cuda"
        ),
        {"paircount_partials": 2, "paircount_segment_sum": 2},
        launches_total,
    )
    stages["crosscorrelate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nz = RedshiftData.from_corrfuncs(wsp)
    torch.cuda.synchronize()
    stages["from_corrfuncs"] = time.perf_counter() - t0
    t_path = time.perf_counter() - t_path
    log(f"main path (cold) {t_path:.2f} s: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in stages.items()))
    check_nz(nz, "main path")
    log(f"n(z) head: {np.array2string(nz.data[:4], precision=4)}")

    log("-- w_ss path (autocorrelate, Landy-Szalay)")
    (wss,), _ = run_path(
        "w_ss (autocorrelate)",
        lambda: autocorrelate(config, reference, randoms, device="cuda"),
        {"paircount_partials_binned": 3, "paircount_segment_sum": 3},
        launches_total,
    )
    check(wss.get_estimator().name == "LS", "w_ss does not use Landy-Szalay")
    nz_ss = RedshiftData.from_corrfuncs(wsp, ref_corr=wss)
    check_nz(nz_ss, "w_sp + w_ss")
    log(f"n(z) with ref_corr head: {np.array2string(nz_ss.data[:4], precision=4)}")

    log("-- config B path (3 scales, rweight=-1, resolution 32: direct counting)")
    config_b = configs["B"]

    def direct_path():
        return (
            crosscorrelate(config_b, reference, unknown, ref_rand=randoms, device="cuda"),
            autocorrelate(config_b, reference, randoms, device="cuda"),
        )

    (wsp_b, wss_b), _ = run_path(
        "config B", direct_path,
        {"paircount_partials_direct": 2, "paircount_partials_direct_binned": 3},
        launches_total,
    )
    check(len(wsp_b) == 3 and len(wss_b) == 3, "config B has not 3 scales")
    for s, (a, b) in enumerate(zip(wsp_b, wss_b)):
        check_nz(RedshiftData.from_corrfuncs(a, ref_corr=b), f"config B scale {s}")

    log("-- scalar path (kappa: signed weights)")

    def scalar_path():
        return (
            crosscorrelate_scalar(config, reference, unknown, unk_rand=randoms, device="cuda"),
            autocorrelate_scalar(config, reference, device="cuda"),
        )

    ((kn,), (kk,)), scalar_launches = run_path(
        "scalar", scalar_path,
        {"paircount_partials": 4, "paircount_partials_binned": 2},
        launches_total,
    )
    for label, corr in (("kn", kn), ("kk", kk)):
        data = corr.sample()
        check(corr.get_estimator().name == "SC", f"{label} estimator")
        check(bool(np.all(np.isfinite(data.data))), f"{label} samples not finite")

    log("-- wide-grid path (edges up to 1.35 rad: arcsine index)")
    config_wide = configs["wide"]

    def wide_path():
        return (
            crosscorrelate(config_wide, reference, unknown, ref_rand=randoms, device="cuda"),
            autocorrelate(config_wide, reference, randoms, device="cuda"),
        )

    (wsp_w, wss_w), _ = run_path(
        "wide grid", wide_path,
        {"paircount_partials_arcsine": 2, "paircount_partials_arcsine_binned": 3},
        launches_total,
    )
    for s, (a, b) in enumerate(zip(wsp_w, wss_w)):
        for label, corr in (("w_sp", a), ("w_ss", b)):
            check(bool(np.all(np.isfinite(corr.sample().data))),
                  f"wide grid {label} scale {s} not finite")
    # against the union-edge cumulative counts of the same pairs (K1.1 /
    # K1.2 with 28 edges), the JAX package's wide-grid tolerance 5e-4
    links_w = PatchLinkage.from_catalogs(config_wide, *catalogs)
    for count in ("cross DD", "auto DD"):
        tiles1, tiles2, pairs = engine_inputs(links_w, catalogs, count)
        table, _, direct, mapper = links_w.engine_table()
        via_direct = mapper.counts_to_scales(count_pairs_tiles(
            tiles1, tiles2, pairs, table, device="cuda", direct=direct
        ))
        via_cumulative = links_w.edges.counts_to_scales(count_pairs_tiles(
            tiles1, tiles2, pairs, links_w.edges.chord2_table, device="cuda"
        ))
        err = max(
            np.abs(via_direct[s] - via_cumulative[s]).max()
            / np.abs(via_cumulative[s]).max()
            for s in range(len(via_direct))
        )
        log(f"wide grid {count}: direct (arcsine) vs union-edge cumulative, "
            f"per-scale max|err|/max {err:.3e}")
        check(err <= 5e-4, f"wide grid {count}: direct off the cumulative counts")

    log("-- many-scale path (10 overlapping scales, 18 above-entries per bin)")
    config_many = configs["many"]
    wsp_m, _ = run_path(
        "many scales",
        lambda: crosscorrelate(
            config_many, reference, unknown, ref_rand=randoms, device="cuda"
        ),
        {"paircount_partials_direct": 4, "paircount_segment_sum": 2},
        launches_total,
    )
    check(len(wsp_m) == len(CONFIG_MANY["rmin"]), "many scales: wrong scale count")
    for s, corr in enumerate(wsp_m):
        check_nz(RedshiftData.from_corrfuncs(corr), f"many scales scale {s}")
    # against the union-edge cumulative counts of the same pairs (K1.1 with
    # 51 edges), within the direct mode's oracle tolerance
    links_m = PatchLinkage.from_catalogs(config_many, *catalogs)
    tiles1, tiles2, pairs = engine_inputs(links_m, catalogs, "cross DD")
    table, _, direct, mapper = links_m.engine_table()
    via_direct = mapper.counts_to_scales(count_pairs_tiles(
        tiles1, tiles2, pairs, table, device="cuda", direct=direct,
    ))
    via_cumulative = links_m.edges.counts_to_scales(count_pairs_tiles(
        tiles1, tiles2, pairs, links_m.edges.chord2_table, device="cuda"
    ))
    err = max(
        np.abs(via_direct[s] - via_cumulative[s]).max()
        / np.abs(via_cumulative[s]).max()
        for s in range(len(via_direct))
    )
    main_path = max(
        np.abs(main_path_counts(corr.dd, pairs, False) - via_cumulative[s]).max()
        / np.abs(via_cumulative[s]).max()
        for s, corr in enumerate(wsp_m)
    )
    log(f"many scales cross DD ({links_m.edges.num_edges} union edges): direct "
        f"vs union-edge cumulative, per-scale max|err|/max {err:.3e}, main-path "
        f"patch-pair counts {main_path:.3e}")
    check(max(err, main_path) <= DIRECT_ORACLE_RTOL,
          "many scales: direct off the cumulative counts")

    log("-- float64 oracle")
    oracles = oracle_check(catalogs, config, wsp)
    wss_oracle_check(catalogs, config, wss)
    direct_oracle_check(catalogs, config_b, wsp_b, wss_b)
    scalar_oracle_check(catalogs, config, kn, kk)

    log("-- audit path (crosscorrelate, audit=True)")
    audit_checks(card, catalogs, config, wsp, oracles, launches_total)
    del oracles
    audit_flip(card, launches_total)
    audit_blocked(card, config, launches_total)

    log("-- timing")
    paths = {
        "main (crosscorrelate + n(z))": (
            lambda: RedshiftData.from_corrfuncs(crosscorrelate(
                config, reference, unknown, ref_rand=randoms, device="cuda"
            )[0]),
            config, ["cross DD", "cross RD"], WARM_RUNS,
        ),
        "w_ss (autocorrelate + n(z) with ref_corr)": (
            lambda: RedshiftData.from_corrfuncs(
                wsp, ref_corr=autocorrelate(
                    config, reference, randoms, device="cuda"
                )[0],
            ),
            config, ["auto DD", "auto DR", "auto RR"], WARM_RUNS,
        ),
        "config B (crosscorrelate + autocorrelate + 3 n(z))": (
            lambda: [
                RedshiftData.from_corrfuncs(a, ref_corr=b)
                for a, b in zip(*direct_path())
            ],
            config_b,
            ["cross DD", "cross RD", "auto DD", "auto DR", "auto RR"],
            WARM_RUNS,
        ),
        "scalar (crosscorrelate_scalar + autocorrelate_scalar)": (
            lambda: [corr[0].sample() for corr in scalar_path()],
            config,
            ["scalar kn DD", "cross DD", "scalar kn DR", "cross DR",
             "scalar kk DD", "auto DD"],
            WARM_RUNS,
        ),
        "wide grid (crosscorrelate + autocorrelate)": (
            wide_path, config_wide,
            ["cross DD", "cross RD", "auto DD", "auto DR", "auto RR"], 3,
        ),
        "many scales (crosscorrelate + 10 n(z))": (
            lambda: [
                RedshiftData.from_corrfuncs(corr) for corr in crosscorrelate(
                    config_many, reference, unknown, ref_rand=randoms,
                    device="cuda",
                )
            ],
            config_many, ["cross DD", "cross RD"], 3,
        ),
    }
    torch.cuda.reset_peak_memory_stats()
    warm_medians = {}
    for label, (fn, path_config, counts, runs) in paths.items():
        warm, lo, hi = warm_time(fn, runs)
        warm_medians[label] = warm
        links = PatchLinkage.from_catalogs(path_config, *catalogs)
        candidates = 0
        for count in counts:
            rows, cols, binned2, mode = COUNTS[count]
            candidates += links.engine_work_stats(
                catalogs[rows], None if cols is None else catalogs[cols],
                binned2=binned2, mode=mode,
            )["candidate_pairs"]
        log(f"[{card}] {label}: warm {warm:.4f} s (median of {runs}) "
            f"[{lo:.4f}, {hi:.4f}], {candidates:.4e} candidate pairs -> "
            f"{candidates / warm:.4e} pairs/s")
        engine_ms = engine_times(card, label, links, catalogs, counts)
        log(f"[{card}] {label}: engine kernels {engine_ms:.3f} ms of the "
            f"{warm * 1e3:.3f} ms warm measurement")
    log(f"peak device memory over the timed paths "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    log("-- surface: build_trees on the card, streaming ingestion from a generator")
    surface_phase(card, config, catalogs, wsp,
                  warm_medians["main (crosscorrelate + n(z))"], launches_total)

    t0 = time.perf_counter()
    log("-- sharded: crosscorrelate in every layout, autocorrelate and config B "
        "under ring")
    sharded_phase(
        card, configs, catalogs, {"cross": [wsp], "auto": [wss], "B": wsp_b},
        launches_total,
    )
    log("-- two processes: gloo, a global mesh of 2 x 2 shards")
    two_process_phase(card, config, catalogs)
    log(f"sharded and two-process phases {time.perf_counter() - t0:.1f} s")
    del catalogs, reference, unknown, randoms

    log("-- survey path (blocked crosscorrelate over disk caches, 7M rows)")
    survey_path(card, config, launches_total)

    log("-- batch pipeline: the command line over the tomographic task graph")
    t0 = time.perf_counter()
    cli_phase(card, launches_total)
    log(f"batch pipeline phase {time.perf_counter() - t0:.1f} s")

    log("-- survey-scale proofs at a reduced size (4M-row survey, 1M-row pipeline)")
    t0 = time.perf_counter()
    proof_phase(card, launches_total)
    log(f"[{card}] proof phase {time.perf_counter() - t0:.1f} s")

    # K1.5 is K1.1 / K1.2 on signed weights: its launches are those of the
    # scalar path (half of them the kappa counts, half the nn normalisation)
    for key, base in (
        ("paircount_partials_signed", "paircount_partials"),
        ("paircount_partials_binned_signed", "paircount_partials_binned"),
    ):
        launches_total[key] = scalar_launches.get(base, 0)
    kernels = []
    for key, result in kernel_results.items():
        check(launches_total.get(key, 0) > 0, f"{key} never launched on a path")
        kernels.append({
            "name": key,
            "route": "cuda",
            "source": SOURCE,
            "replaces": result.get("replaces", REPLACES),
            "launches": launches_total[key],
            "max_abs_err": result["err"][0],
            "ms": result["ms"],
            "plain_ms": result["plain_ms"],
            "bound_ms": result["bound_ms"],
            "bound_by": result["bound_by"],
            "library_ms": result["library_ms"],
        })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--survey-child"]:
        survey_child(*sys.argv[2:5])
    elif sys.argv[1:2] == ["--mp-child"]:
        mp_child(sys.argv[2])
    elif sys.argv[1:2] == ["--audit-survey"]:
        os.environ["YAWT_NUM_DEVICES"] = "1"
        smi = environment()
        build_kernels()
        audit_survey(smi)
    else:
        main()
