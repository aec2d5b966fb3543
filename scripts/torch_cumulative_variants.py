#!/usr/bin/env python3
"""Time the port's cumulative pair-count kernel (K1.1 / K1.2) or its flag
kernel (K2.1, kernel C) against an earlier source of it, in one call on one
NVIDIA card.

Run from the root of a checkout on a machine with a CUDA card::

    python3 scripts/torch_cumulative_variants.py --parent OLD.cu [--kernel flags]

It builds ``yet_another_wizz_tpu_torch/csrc/paircount.cu`` and ``OLD.cu``
in cumulative mode, one ``nvcc`` each, together. A library that exports
``yawt_paircount_chunk`` has the current C interface: it is loaded with
``cuda_paircount._load`` and driven through
``cuda_paircount.paircount_partials``. One without it has the interface
from before the chunk skip, which takes no chunk caps, and is bound as
such. On the inputs of ``chip_smoke.py`` (the JAX package's benchmark
size) it checks each build against the plain PyTorch version on the
first 512 tile pairs, checks that both builds give the same partials bit
for bit on the full lists, with real and with unit weights (a skipped
pair adds +0, and each row still sums its columns in order), and times
both on the full headline DD and RD lists (K1.1) and the w_ss DD list
(K1.2) with CUDA events, in turns (parent, shipped, shipped, parent). It
prints the card's name and power limit and each build's ptxas summary; it
exits non-zero on any disagreement.

With ``--kernel flags`` it times kernel C instead. A library that exports
``yawt_flag_reach`` has the current flag interface (reach, triage and
evaluation, a workspace from the caller) and runs through
``cuda_paircount.boundary_flags_cuda``; one without it has the interface
of one launch per tile pair, from before the work list, and is bound as
such. On the full headline DD and RD lists and the w_ss DD list, with the
audit's band, it checks both builds bit for bit against
``boundary_flags_torch`` and times
them in turns, with CUDA events around each call (what a caller waits for,
the host's launch gaps included) and as replays of CUDA graphs of
:data:`GRAPH_CALLS` calls (the device alone); then it runs the blocked
audit of ``chip_smoke.py::audit_blocked`` (``autocorrelate(audit=True,
max_resident_patches=16)`` on 100k + 500k points) once per build in turns
and prints each build's flag passes and their milliseconds on the card,
which must flag the same slots; last it replays those flag passes alone,
per build in turns, summed over the passes: events around each call and
CUDA graphs of each.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

COUNTS = ("cross DD", "cross RD", "auto DD")
REPS = 5
GRAPH_CALLS = 10


def build(name: str, source: Path) -> tuple[Path, str]:
    """The cumulative-mode library of ``source`` and the compiler's log."""
    from torch.utils.cpp_extension import CUDA_HOME

    from yet_another_wizz_tpu_torch.ops import cuda_paircount
    from yet_another_wizz_tpu_torch.utils.misc import (
        build_directory,
        build_shared_library,
    )

    target = build_directory("yawt_torch_variants") / f"lib_{name}.so"
    target.unlink(missing_ok=True)
    log = build_shared_library(
        [os.path.join(CUDA_HOME, "bin", "nvcc"), *cuda_paircount.NVCC_FLAGS,
         "-DYAWT_DIRECT=0"],
        [source], target, timeout=600,
    )
    return target, log


def launcher(target: Path):
    """``run(lanes1, lanes2, tile1, tile2, table, cols_binned)`` through the
    library's C interface: the current one, or the one before the chunk
    skip."""
    import torch

    from yet_another_wizz_tpu_torch.ops import cuda_paircount

    if hasattr(ctypes.CDLL(str(target)), "yawt_paircount_chunk"):
        lib = cuda_paircount._load(target, 0)

        def run(lanes1, lanes2, tile1, tile2, table, cols_binned):
            cuda_paircount._libs[0] = lib
            return cuda_paircount.paircount_partials(
                lanes1, lanes2, tile1, tile2, table, cols_binned=cols_binned
            )

        return run

    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = ctypes.CDLL(str(target)).yawt_paircount_partials
    fn.argtypes = [ptr, ptr, ptr, ptr, i64, ptr] + [i32] * 8 + [
        ptr, i32, ptr, ptr,
    ]
    fn.restype = i32

    def run_without_caps(lanes1, lanes2, tile1, tile2, table, cols_binned):
        num_bins, num_edges = table.shape
        out = torch.empty(
            (len(tile1), num_bins, num_edges), dtype=torch.float32,
            device=lanes1.device,
        )
        status = fn(
            lanes1.data_ptr(), lanes2.data_ptr(), tile1.data_ptr(),
            tile2.data_ptr(), len(tile1), table.data_ptr(), num_bins,
            num_edges, num_edges, 0, num_edges, lanes1.shape[2],
            int(cols_binned), 0, None, 0, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
        chip_smoke.check(status == 0, f"launch failed with CUDA error {status}")
        return out

    return run_without_caps


def flag_launcher(target: Path):
    """``run(lanes1, lanes2, tile1, tile2, table, band, cols_binned)``,
    the flags of a library's kernel C through its C interface: the current
    one (through the wrapper), or the one-launch interface from before the
    work list (through a replay of that source's wrapper)."""
    import torch

    from yet_another_wizz_tpu_torch.ops import cuda_paircount

    if hasattr(ctypes.CDLL(str(target)), "yawt_flag_reach"):
        lib = cuda_paircount._load(target, 0)

        def run(lanes1, lanes2, tile1, tile2, table, band, cols_binned):
            cuda_paircount._libs[0] = lib
            return cuda_paircount.boundary_flags_cuda(
                lanes1, lanes2, tile1, tile2, table, band,
                cols_binned=cols_binned,
            )

        return run

    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = ctypes.CDLL(str(target)).yawt_boundary_flags
    fn.argtypes = [ptr] * 6 + [i64, ptr, ptr] + [i32] * 6 + [ptr, ptr]
    fn.restype = i32
    check = cuda_paircount._check

    def run_one_launch(lanes1, lanes2, tile1, tile2, table, band, cols_binned):
        # the one-launch source's boundary_flags_cuda, its checks included,
        # so that both builds pay the same host work around their launches
        device = lanes1.device
        check(lanes1, "lanes1", torch.float32, 3, device)
        check(lanes2, "lanes2", torch.float32, 3, device)
        check(tile1, "tile1", torch.int32, 1, device)
        check(tile2, "tile2", torch.int32, 1, device)
        check(table, "chord2_table", torch.float32, 2, device)
        check(band, "band_table", torch.float32, 2, device)
        _, channels, tile_size = lanes1.shape
        chip_smoke.check(
            channels == 8 and tuple(lanes2.shape[1:]) == (8, tile_size)
            and tile1.shape == tile2.shape and band.shape == table.shape,
            "inputs the flag kernel does not take",
        )
        num_pairs = len(tile1)
        num_bins, num_edges = table.shape
        caps1 = cuda_paircount._device_caps(lanes1)
        caps2 = cuda_paircount._device_caps(lanes2)
        flags = torch.empty(num_pairs, dtype=torch.bool, device=device)
        cuda_paircount.build()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            for edge0 in range(0, num_edges, cuda_paircount.MAX_EDGES_PER_LAUNCH):
                status = fn(
                    lanes1.data_ptr(), lanes2.data_ptr(), caps1.data_ptr(),
                    caps2.data_ptr(), tile1.data_ptr(), tile2.data_ptr(),
                    num_pairs, table.data_ptr(), band.data_ptr(), num_bins,
                    num_edges, edge0,
                    min(cuda_paircount.MAX_EDGES_PER_LAUNCH, num_edges - edge0),
                    tile_size, int(cols_binned), flags.data_ptr(), stream,
                )
                chip_smoke.check(
                    status == 0, f"launch failed with CUDA error {status}"
                )
        return flags

    return run_one_launch


def blocked_catalogs() -> tuple:
    """The data and random catalogs of ``chip_smoke.py::audit_blocked``."""
    from yet_another_wizz_tpu_torch.catalog import Catalog
    from yet_another_wizz_tpu_torch.examples import generate_mock_data

    mock = generate_mock_data(
        num_reference=chip_smoke.NUM_REFERENCE // chip_smoke.AUDIT_CUT,
        num_unknown=1,
        num_randoms=chip_smoke.NUM_RANDOMS // chip_smoke.AUDIT_CUT,
        seed=chip_smoke.SEED,
    )
    data = Catalog.from_arrays(
        **mock["reference"], degrees=False, patch_num=chip_smoke.NUM_PATCHES,
        device="cuda",
    )
    random = Catalog.from_arrays(
        **mock["randoms"], degrees=False, patch_centers=data.get_centers(),
        device="cuda",
    )
    return data, random


def blocked_audit(run, catalogs, lists: list | None = None) -> tuple[list, float]:
    """The blocked audit of ``chip_smoke.py::audit_blocked`` on
    ``catalogs`` with the flag pass through ``run``: its audit records and
    the flag passes' milliseconds on the card (CUDA events around each
    pass's launches). With ``lists``, the flag passes' inputs are appended
    to it."""
    import torch

    from yet_another_wizz_tpu_torch.config import Configuration
    from yet_another_wizz_tpu_torch.correlation.measurements import autocorrelate
    from yet_another_wizz_tpu_torch.ops import paircount

    dispatch = paircount.boundary_flags
    events = []

    def flags(lanes1, lanes2, tile1, tile2, table, band, *, cols_binned=False,
              chunk_size=None):
        if lists is not None:
            lists.append((lanes1, lanes2, tile1, tile2, table, band, cols_binned))
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        flagged = run(lanes1, lanes2, tile1, tile2, table, band, cols_binned)
        stop.record()
        events.append((start, stop))
        return flagged

    paircount.boundary_flags = flags
    paircount.reset_audit_stats()
    try:
        autocorrelate(
            Configuration.create(**chip_smoke.CONFIG), *catalogs,
            device="cuda", audit=True, max_workers=len(os.sched_getaffinity(0)),
            max_resident_patches=chip_smoke.AUDIT_RESIDENT,
        )
    finally:
        paircount.boundary_flags = dispatch
    torch.cuda.synchronize()
    stats = list(paircount.AUDIT_STATS)
    return stats, sum(start.elapsed_time(stop) for start, stop in events)


def time_flags(card: str, runs: dict) -> None:
    """Kernel C of both builds on the three lists and in the blocked
    audit, in turns."""
    import numpy as np
    import torch

    from yet_another_wizz_tpu_torch.config import Configuration
    from yet_another_wizz_tpu_torch.correlation.measurements import PatchLinkage
    from yet_another_wizz_tpu_torch.ops.paircount import (
        audit_band,
        boundary_flags_torch,
    )

    catalogs, _ = chip_smoke.make_catalogs()
    links = PatchLinkage.from_catalogs(
        Configuration.create(**chip_smoke.CONFIG), *catalogs
    )
    device = torch.device("cuda")
    table_np = np.ascontiguousarray(links.edges.chord2_table, np.float32)
    table = torch.from_numpy(table_np).to(device)
    band = torch.from_numpy(
        audit_band(links.edges.edges, table_np).astype(np.float32)
    ).to(device)
    order = [*runs, *reversed(runs)]
    for count in COUNTS:
        tiles1, tiles2, pairs = chip_smoke.engine_inputs(links, catalogs, count)
        binned = tiles2.binned
        args = (
            tiles1.device_data(device), tiles2.device_data(device),
            torch.from_numpy(pairs.tile1.astype(np.int32)).to(device),
            torch.from_numpy(pairs.tile2.astype(np.int32)).to(device),
            table, band,
        )
        plain = boundary_flags_torch(
            *args[:2], args[2].long(), args[3].long(), *args[4:],
            cols_binned=binned,
        )
        for name, run in runs.items():
            flags = run(*args, binned)
            torch.cuda.synchronize()
            chip_smoke.check(
                torch.equal(flags, plain),
                f"{count}: the {name} flag kernel differs from the plain flag pass",
            )
        events = {name: [] for name in runs}
        graphs = {name: [] for name in runs}
        for name in order:
            events[name].append(chip_smoke.cuda_ms(
                lambda: runs[name](*args, binned), REPS
            ))
        for name in order:
            graphs[name].append(chip_smoke.graph_ms(
                lambda: runs[name](*args, binned), GRAPH_CALLS
            ))
        line = "; ".join(
            f"{name} events {statistics.mean(events[name]):.4f} ms "
            f"({' / '.join(f'{t:.4f}' for t in events[name])}), graphs "
            f"{statistics.mean(graphs[name]):.4f} ms "
            f"({' / '.join(f'{t:.4f}' for t in graphs[name])})"
            for name in runs
        )
        chip_smoke.log(f"[{card}] flags {count} ({pairs.num_pairs} tile pairs, "
                       f"{int(plain.sum())} flagged): {line}; both bit for bit "
                       "the plain flag pass")
    del catalogs, links
    catalogs = blocked_catalogs()
    audits = {name: [] for name in runs}
    for name in order:
        audits[name].append(blocked_audit(runs[name], catalogs))
    first = {name: records[0][0] for name, records in audits.items()}
    parent, shipped = first.values()
    chip_smoke.check(
        chip_smoke.same_flagged_slots(parent, shipped),
        "blocked audit: the two builds flag other slots",
    )
    # the same flag passes again, alone: events around each call (host
    # included) and CUDA graphs of each (the device alone), summed
    lists = []
    blocked_audit(next(iter(runs.values())), catalogs, lists)
    sizes = [len(args[2]) for args in lists]
    events = {name: [] for name in runs}
    graphs = {name: [] for name in runs}
    for name in order:
        events[name].append(sum(
            chip_smoke.cuda_ms(lambda: runs[name](*args), REPS) for args in lists
        ))
        graphs[name].append(sum(
            chip_smoke.graph_ms(lambda: runs[name](*args), GRAPH_CALLS)
            for args in lists
        ))
    chip_smoke.log(
        f"[{card}] blocked audit's {len(lists)} lists alone ({min(sizes)} to "
        f"{max(sizes)} tile pairs, {sum(sizes)} in all): " + "; ".join(
            f"{name} events {' / '.join(f'{t:.3f}' for t in events[name])} ms, "
            f"graphs {' / '.join(f'{t:.3f}' for t in graphs[name])} ms"
            for name in runs
        )
    )
    chip_smoke.log(f"[{card}] blocked audit: " + "; ".join(
        f"{name} {len(records[0][0])} flag passes, "
        + " / ".join(f"{ms:.3f}" for _, ms in records) + " ms of flag pass"
        for name, records in audits.items()
    ) + f"; the same {sum(len(r['flagged_slots']) for r in shipped)} "
        "block-pair slots flagged")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--parent", type=Path, required=True, help="an earlier paircount.cu"
    )
    parser.add_argument(
        "--kernel", choices=("partials", "flags"), default="partials",
        help="kernel A's cumulative instances (default) or kernel C",
    )
    args = parser.parse_args()
    card = chip_smoke.environment()

    import torch

    from yet_another_wizz_tpu_torch.config import Configuration
    from yet_another_wizz_tpu_torch.correlation.measurements import PatchLinkage
    from yet_another_wizz_tpu_torch.ops import cuda_paircount
    from yet_another_wizz_tpu_torch.ops.paircount import partial_counts_torch

    sources = {"parent": args.parent, "shipped": cuda_paircount.SOURCE}
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc each, together
        built = dict(zip(sources, pool.map(build, sources, sources.values())))
    runs = {}
    for name, (target, log) in built.items():
        runs[name] = (flag_launcher if args.kernel == "flags" else launcher)(target)
        for line in chip_smoke.ptxas_summary(log):
            chip_smoke.log(f"  {name} ptxas: {line}")
    if args.kernel == "flags":
        time_flags(card, runs)
        return

    catalogs, _ = chip_smoke.make_catalogs()
    config = Configuration.create(**chip_smoke.CONFIG)
    links = PatchLinkage.from_catalogs(config, *catalogs)
    device = torch.device("cuda")
    table = torch.from_numpy(links.engine_table()[0]).to(device)
    totals = dict.fromkeys(runs, 0.0)
    for count in COUNTS:
        tiles1, tiles2, pairs = chip_smoke.engine_inputs(links, catalogs, count)
        binned = tiles2.binned
        lanes1, lanes2 = tiles1.device_data(device), tiles2.device_data(device)
        tile1 = torch.from_numpy(pairs.tile1).to(device)
        tile2 = torch.from_numpy(pairs.tile2).to(device)
        plain = partial_counts_torch(
            lanes1, lanes2, tile1[:512].long(), tile2[:512].long(), table,
            cols_binned=binned, chunk_size=chip_smoke.PLAIN_CHUNK,
        )
        for run in runs.values():
            chip_smoke.compare(
                run(lanes1, lanes2, tile1[:512], tile2[:512], table, binned),
                plain,
            )
        units = (chip_smoke.unit_weights(lanes1), chip_smoke.unit_weights(lanes2))
        for label, (rows, cols) in (("real", (lanes1, lanes2)), ("unit", units)):
            parent, shipped = (
                run(rows, cols, tile1, tile2, table, binned)
                for run in runs.values()
            )
            torch.cuda.synchronize()
            chip_smoke.check(
                torch.equal(parent, shipped),
                f"{count} {label} weights: the shipped kernel differs from the "
                "parent's",
            )
            del parent, shipped
        times = {name: [] for name in runs}
        for name in [*runs, *reversed(runs)]:
            times[name].append(chip_smoke.cuda_ms(
                lambda: runs[name](lanes1, lanes2, tile1, tile2, table, binned),
                REPS,
            ))
        for name, ms in times.items():
            totals[name] += statistics.mean(ms)
        line = ", ".join(
            f"{name} {statistics.mean(ms):.3f} ms "
            f"({' / '.join(f'{t:.3f}' for t in ms)})"
            for name, ms in times.items()
        )
        chip_smoke.log(f"[{card}] {count} ({pairs.num_pairs} tile pairs, "
                       f"{'K1.2' if binned else 'K1.1'}): {line}; bitwise "
                       "equal (real and unit weights)")
    chip_smoke.log(f"[{card}] DD + RD + w_ss DD: " + ", ".join(
        f"{name} {ms:.3f} ms" for name, ms in totals.items()))


if __name__ == "__main__":
    main()
