#!/usr/bin/env python3
"""Time the port's cumulative pair-count kernel (K1.1 / K1.2) against an
earlier source of it, in one call on one NVIDIA card.

Run from the root of a checkout on a machine with a CUDA card::

    python3 scripts/torch_cumulative_variants.py --parent OLD.cu

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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--parent", type=Path, required=True, help="an earlier paircount.cu"
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
        runs[name] = launcher(target)
        for line in chip_smoke.ptxas_summary(log):
            chip_smoke.log(f"  {name} ptxas: {line}")

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
