#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``yet_another_wizz_tpu_torch``) on one
NVIDIA card.

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit::

    python3 chip_smoke.py

It builds the CUDA kernels from ``yet_another_wizz_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version on the card, drives
the main path once at the size of the JAX package's headline benchmark
(mock data -> ``Catalog.from_arrays`` with 64 kmeans patches ->
``crosscorrelate`` DD + RD -> ``RedshiftData.from_corrfuncs`` with
jackknife), checks the counts against the float64 scipy oracle, and times
the warm measurement. Every phase raises on failure, so the exit code is
non-zero; the last line of standard output is the JSON result
``{"ok": true, "device": {...}}``. Without a CUDA card it exits non-zero
before printing a result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

NUM_REFERENCE = 200_000
NUM_UNKNOWN = 500_000
NUM_RANDOMS = 1_000_000
NUM_PATCHES = 64
NUM_BINS = 11
SEED = 12345
CONFIG = dict(
    rmin=100, rmax=1000, unit="kpc", zmin=0.15, zmax=1.0, num_bins=NUM_BINS
)
RTOL = 1e-6
"""Tolerance of every comparison: relative 1e-6, with an absolute floor
of 1e-6 times the largest reference value. Kernel and plain version share
the chord arithmetic and differ in the order of float32 sums."""
WARM_RUNS = 5
KERNEL_REPS = 5
PLAIN_CHUNK = 64
"""Tile pairs per batch of the plain engine on the card (64 MiB per
(chunk, 512, 512) float32 temporary)."""
SOURCE = "yet_another_wizz_tpu_torch/csrc/paircount.cu"
REPLACES = "yet_another_wizz_tpu/ops/pallas_paircount.py:58"


def log(message: str) -> None:
    print(message, flush=True)


def check(condition: bool, message: str) -> None:
    if not condition:
        raise RuntimeError(message)


def compare(actual, desired) -> tuple[float, float]:
    """``(max_abs_err, max_rel_err)`` of two tensors; raises unless they
    agree within :data:`RTOL` (absolute floor ``RTOL * max|desired|``)."""
    import torch

    actual = actual.double()
    desired = desired.double()
    diff = (actual - desired).abs()
    floor = RTOL * desired.abs().max().item()
    within = diff <= RTOL * desired.abs() + floor
    big = desired.abs() > floor
    rel = (diff[big] / desired.abs()[big]).max().item() if big.any() else 0.0
    check(bool(within.all()), f"disagreement beyond rtol {RTOL}: max rel {rel:.3e}")
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


def build_kernels() -> None:
    from yet_another_wizz_tpu_torch import _native
    from yet_another_wizz_tpu_torch.ops import cuda_paircount

    t0 = time.perf_counter()
    compiler_log = cuda_paircount.build()
    log(f"built CUDA kernels in {time.perf_counter() - t0:.2f} s")
    for line in compiler_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")
    t0 = time.perf_counter()
    log(f"native host library: {'built' if _native.enabled() else 'MISSING'} "
        f"in {time.perf_counter() - t0:.2f} s")


def make_catalogs():
    from yet_another_wizz_tpu_torch.catalog import Catalog
    from yet_another_wizz_tpu_torch.examples import generate_mock_data

    stages = {}
    t0 = time.perf_counter()
    mock = generate_mock_data(
        num_reference=NUM_REFERENCE, num_unknown=NUM_UNKNOWN,
        num_randoms=NUM_RANDOMS, seed=SEED,
    )
    stages["mock"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reference = Catalog.from_arrays(
        **mock["reference"], degrees=False, patch_num=NUM_PATCHES
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


def kernels_vs_plain(catalogs, config) -> dict:
    """Each kernel against its plain version on the headline DD inputs."""
    import numpy as np
    import torch

    from yet_another_wizz_tpu_torch.correlation.measurements import PatchLinkage
    from yet_another_wizz_tpu_torch.ops import cuda_paircount
    from yet_another_wizz_tpu_torch.ops.paircount import (
        partial_counts_torch,
        segment_sum_torch,
    )

    reference, unknown, randoms = catalogs
    links = PatchLinkage.from_catalogs(config, reference, unknown, randoms)
    tiles1, tiles2, pairs = links._build_engine_inputs(
        reference, unknown, mode="nn"
    )
    device = torch.device("cuda")
    lanes1 = tiles1.device_data(device)
    lanes2 = tiles2.device_data(device)
    table = torch.from_numpy(links.edges.chord2_table).to(device)
    tile1 = torch.from_numpy(pairs.tile1).to(device)
    tile2 = torch.from_numpy(pairs.tile2).to(device)
    slot = torch.from_numpy(pairs.slot.astype(np.int64)).to(device)
    offsets = torch.from_numpy(
        np.searchsorted(pairs.slot, np.arange(pairs.num_slots + 1))
    ).to(device)
    log(f"DD inputs: {pairs.num_pairs} tile pairs in {pairs.num_slots} slots, "
        f"lanes {tuple(lanes1.shape)} x {tuple(lanes2.shape)}, "
        f"table {tuple(table.shape)}")

    def partials():
        return cuda_paircount.paircount_partials(
            lanes1, lanes2, tile1, tile2, table
        )

    def plain_partials():
        return partial_counts_torch(
            lanes1, lanes2, tile1.long(), tile2.long(), table,
            chunk_size=PLAIN_CHUNK,
        )

    first, second = partials(), partials()
    torch.cuda.synchronize()
    check(torch.equal(first, second), "paircount_partials is not deterministic")
    plain = plain_partials()
    torch.cuda.synchronize()
    err_a = compare(first, plain)

    def seg():
        return cuda_paircount.segment_sum(first, slot, offsets, pairs.num_slots)

    def plain_seg():
        return segment_sum_torch(first, slot, pairs.num_slots)

    out, out2 = seg(), seg()
    torch.cuda.synchronize()
    check(torch.equal(out, out2), "segment_sum is not deterministic")
    err_b = compare(out, plain_seg())

    results = {
        "paircount_partials": dict(
            err=err_a, ms=cuda_ms(partials, KERNEL_REPS),
            plain_ms=cuda_ms(plain_partials, 2),
        ),
        "paircount_segment_sum": dict(
            err=err_b, ms=cuda_ms(seg, KERNEL_REPS),
            plain_ms=cuda_ms(plain_seg, KERNEL_REPS),
        ),
    }
    for name, r in results.items():
        log(f"{name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
            f"max abs err {r['err'][0]:.3e}, max rel err {r['err'][1]:.3e}, "
            "two kernel runs bitwise equal")
    return results


def oracle_check(catalogs, config, wsp) -> None:
    """DD and RD against the float64 scipy oracle: the per-slot cumulative
    counts of the engine, the main path's per-patch-pair counts, and the
    per-bin totals (the JAX package's benchmark metric)."""
    import numpy as np

    from yet_another_wizz_tpu_torch.correlation.measurements import PatchLinkage
    from yet_another_wizz_tpu_torch.ops.cpu_oracle import (
        count_pairs_oracle_multiprocess,
    )
    from yet_another_wizz_tpu_torch.ops.paircount import (
        _unpack_tileset,
        count_pairs_tiles,
    )

    reference, unknown, randoms = catalogs
    links = PatchLinkage.from_catalogs(config, reference, unknown, randoms)
    workers = len(os.sched_getaffinity(0))
    for name, rows, counts in (
        ("DD", reference, wsp.dd), ("RD", randoms, wsp.rd)
    ):
        tiles1, tiles2, pairs = links._build_engine_inputs(
            rows, unknown, mode="nn"
        )
        xyz1, w1, z1, p1 = _unpack_tileset(tiles1)
        xyz2, w2, _, p2 = _unpack_tileset(tiles2)
        t0 = time.perf_counter()
        oracle = count_pairs_oracle_multiprocess(
            xyz1, w1, z1, p1, xyz2, w2, None, p2,
            pairs.slot_patches, links.edges.edges, max_workers=workers,
        )
        t_oracle = time.perf_counter() - t0
        engine = count_pairs_tiles(
            tiles1, tiles2, pairs, links.edges.chord2_table, device="cuda"
        )
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
        log(f"{name} vs float64 oracle ({workers} processes, {t_oracle:.1f} s): "
            f"per-slot max|err|/max|oracle| {slot_err:.3e}, main-path "
            f"patch-pair counts {path_err:.3e}, per-bin totals max rel "
            f"{total_rel:.3e} (per-slot max rel {slot_rel:.3e}, not gated: a "
            "pair within float32 resolution of an edge moves one pair weight)")
        check(slot_err <= RTOL, f"{name} per-slot counts off the oracle")
        check(path_err <= RTOL, f"{name} main-path counts off the oracle")
        check(total_rel <= RTOL, f"{name} per-bin totals off the oracle")


def main() -> None:
    card = environment()

    import numpy as np
    import torch

    from yet_another_wizz_tpu_torch.config import Configuration
    from yet_another_wizz_tpu_torch.correlation.measurements import (
        PatchLinkage,
        crosscorrelate,
    )
    from yet_another_wizz_tpu_torch.ops import cuda_paircount
    from yet_another_wizz_tpu_torch.ops.paircount import count_pairs_tiles
    from yet_another_wizz_tpu_torch.redshifts import RedshiftData

    build_kernels()
    config = Configuration.create(**CONFIG)

    log("-- kernels vs plain versions on the card (headline DD inputs)")
    catalogs, _ = make_catalogs()
    kernel_results = kernels_vs_plain(catalogs, config)
    del catalogs

    log("-- main path")
    cuda_paircount.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t_path = time.perf_counter()
    catalogs, stages = make_catalogs()
    reference, unknown, randoms = catalogs
    t0 = time.perf_counter()
    (wsp,) = crosscorrelate(
        config, reference, unknown, ref_rand=randoms, device="cuda"
    )
    stages["crosscorrelate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nz = RedshiftData.from_corrfuncs(wsp)
    torch.cuda.synchronize()
    stages["from_corrfuncs"] = time.perf_counter() - t0
    t_path = time.perf_counter() - t_path
    launches = dict(cuda_paircount.launch_counts)
    log(f"main path (cold) {t_path:.2f} s: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in stages.items()))
    log(f"kernel launches on the main path: {launches}")
    for name, count in launches.items():
        # one launch per count (DD, RD) for up to 16 edges
        check(count >= 2, f"{name} launched {count} times, expected DD and RD")
    for field in ("data", "error", "covariance"):
        check(bool(np.all(np.isfinite(getattr(nz, field)))),
              f"n(z) {field} is not finite")
    check(nz.data.shape == (NUM_BINS,), "n(z) has the wrong shape")
    check(nz.samples.shape == (NUM_PATCHES, NUM_BINS), "wrong sample shape")
    log(f"n(z) head: {np.array2string(nz.data[:4], precision=4)}")

    log("-- float64 oracle")
    oracle_check(catalogs, config, wsp)

    log("-- timing")

    def run_measurement():
        (w,) = crosscorrelate(
            config, reference, unknown, ref_rand=randoms, device="cuda"
        )
        return RedshiftData.from_corrfuncs(w)

    run_measurement()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(WARM_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_measurement()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    warm = statistics.median(times)
    peak = torch.cuda.max_memory_allocated()
    links = PatchLinkage.from_catalogs(config, reference, unknown, randoms)
    work = {
        "DD": links.engine_work_stats(reference, unknown),
        "RD": links.engine_work_stats(randoms, unknown),
    }
    candidates = sum(w["candidate_pairs"] for w in work.values())
    log(f"[{card}] warm measurement (median of {WARM_RUNS}): {warm:.4f} s "
        f"[{min(times):.4f}, {max(times):.4f}], {candidates:.4e} candidate "
        f"pairs -> {candidates / warm:.4e} pairs/s, peak device memory "
        f"{peak / 2**20:.1f} MiB")

    engine_ms = 0.0
    for name, rows in (("DD", reference), ("RD", randoms)):
        tiles1, tiles2, pairs = links._build_engine_inputs(
            rows, unknown, mode="nn"
        )

        def count(backend):
            return count_pairs_tiles(
                tiles1, tiles2, pairs, links.edges.chord2_table,
                backend=backend, device="cuda", defer=True,
                chunk_size=PLAIN_CHUNK,
            )

        kernel_ms = cuda_ms(lambda: count("cuda"), 3)
        plain_ms = cuda_ms(lambda: count("torch"), 1)
        engine_ms += kernel_ms
        log(f"[{card}] {name} count ({work[name]['tile_pairs']} tile pairs, "
            f"{work[name]['candidate_pairs']:.4e} candidate pairs): kernels "
            f"{kernel_ms:.3f} ms ({work[name]['candidate_pairs'] / (kernel_ms * 1e-3):.4e} "
            f"pairs/s), plain PyTorch engine {plain_ms:.3f} ms")
    log(f"[{card}] engine kernels {engine_ms:.3f} ms of the {warm * 1e3:.3f} ms "
        "warm measurement")

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES,
            "launches": launches[name],
            "max_abs_err": result["err"][0],
            "ms": result["ms"],
            "plain_ms": result["plain_ms"],
        }
        for name, result in kernel_results.items()
    ]
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
    main()
