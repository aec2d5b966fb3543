#!/usr/bin/env python3
"""Time the port's direct pair-count kernels (K1.3, small-angle index, and
K1.4, arcsine index) against an earlier source of them, in one call on one
NVIDIA card.

Run from the root of a checkout on a machine with a CUDA card::

    python3 scripts/torch_direct_variants.py --parent OLD.cu \
        [--variant NAME=OTHER.cu ...]

It builds ``yet_another_wizz_tpu_torch/csrc/paircount.cu`` ("shipped"),
``OLD.cu`` ("parent") and each ``--variant`` in both direct modes
(``-DYAWT_DIRECT=1`` and ``2``), one ``nvcc`` each, together, and prints
each build's ptxas summary (registers, blocks of 256 threads per SM,
spills). Every build runs through ``cuda_paircount.paircount_partials``
with its own library in place, so a source whose kernel ignores the chunk
caps and the kept-block total (the direct kernel before its chunk skip)
runs through the same interface. On the inputs of ``chip_smoke.py`` (the
JAX package's benchmark size) it runs the lists of :data:`LISTS`: config
B's cross DD and RD and its binned auto DD (K1.3, three weighted scales,
the benchmark's ``multi`` scales), the first tile pairs of the many-scale
cross DD (K1.3 with 16 + 4 counting edges in two launches) and of the wide
grid's cross DD and binned auto DD (K1.4). On each it checks every build
against the plain PyTorch version on the first tile pairs (within the
direct mode's tolerance) and against the parent bit for bit on the whole
list, with real and with unit weights (a skipped pair adds +0, and each
row still sums its columns in order), checks that the shipped kernel's
count of kept chunk blocks (``engine.chunk_blocks_kept``) is the plain
mirror's sum (``kept_chunk_blocks``), prints the kept share, and times
every build with CUDA events in turns (forwards, then backwards). It
prints the card's name and power limit; it exits non-zero on any
disagreement.
"""

from __future__ import annotations

import argparse
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import chip_smoke  # noqa: E402
from torch_cumulative_variants import REPS, build  # noqa: E402

LISTS = (
    # label, chip_smoke configuration, count, tile pairs (None: all)
    ("B cross DD", "B", "cross DD", None),
    ("B cross RD", "B", "cross RD", None),
    ("B auto DD", "B", "auto DD", None),
    ("many cross DD", "many", "cross DD", 4096),
    ("wide cross DD", "wide", "cross DD", 16384),
    ("wide auto DD", "wide", "auto DD", 8192),
)
CONFIGS = {"B": chip_smoke.CONFIG_B, "many": chip_smoke.CONFIG_MANY,
           "wide": chip_smoke.CONFIG_WIDE}
PLAIN_PAIRS = 256
"""Tile pairs of each list held against the plain version."""


def launcher(target: Path, mode: int):
    """``run(lanes1, lanes2, tile1, tile2, table, cols_binned, direct)``:
    kernel A of the library at ``target`` through the wrapper."""
    from yet_another_wizz_tpu_torch.ops import cuda_paircount

    lib = cuda_paircount._load(target, mode)

    def run(lanes1, lanes2, tile1, tile2, table, cols_binned, direct):
        cuda_paircount._libs[mode] = lib
        return cuda_paircount.paircount_partials(
            lanes1, lanes2, tile1, tile2, table, cols_binned=cols_binned,
            direct=direct,
        )

    return run


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--parent", type=Path, required=True, help="an earlier paircount.cu"
    )
    parser.add_argument(
        "--variant", action="append", default=[], metavar="NAME=PATH",
        help="another paircount.cu to build and time",
    )
    args = parser.parse_args()
    card = chip_smoke.environment()

    import torch

    from yet_another_wizz_tpu_torch.config import Configuration
    from yet_another_wizz_tpu_torch.correlation.measurements import PatchLinkage
    from yet_another_wizz_tpu_torch.ops import cuda_paircount
    from yet_another_wizz_tpu_torch.ops.gweight import counting_width
    from yet_another_wizz_tpu_torch.ops.paircount import (
        chunk_blocks,
        kept_chunk_blocks,
        partial_counts_torch,
    )
    from yet_another_wizz_tpu_torch.utils import tracing

    sources = {"parent": args.parent}
    for variant in args.variant:
        name, _, path = variant.partition("=")
        sources[name] = Path(path)
    sources["shipped"] = cuda_paircount.SOURCE
    jobs = [(name, path, mode) for name, path in sources.items() for mode in (1, 2)]
    with ThreadPoolExecutor(len(jobs)) as pool:  # one nvcc each, together
        built = list(pool.map(lambda job: build(*job), jobs))
    runs = {1: {}, 2: {}}
    for (name, _, mode), (target, log) in zip(jobs, built):
        runs[mode][name] = launcher(target, mode)
        for line in chip_smoke.ptxas_summary(log):
            chip_smoke.log(f"  {name} ptxas: {line}")

    catalogs, _ = chip_smoke.make_catalogs()
    device = torch.device("cuda")
    totals = dict.fromkeys(sources, 0.0)
    for label, config, count, limit in LISTS:
        links = PatchLinkage.from_catalogs(
            Configuration.create(**CONFIGS[config]), *catalogs
        )
        table_np, _, direct, _ = links.engine_table()
        mode = cuda_paircount._mode(direct)
        builds = runs[mode]
        tiles1, tiles2, pairs = chip_smoke.engine_inputs(links, catalogs, count)
        binned = tiles2.binned
        lanes1, lanes2 = tiles1.device_data(device), tiles2.device_data(device)
        table = torch.from_numpy(table_np).to(device)
        k = slice(0, limit)
        tile1 = torch.from_numpy(pairs.tile1[k]).to(device)
        tile2 = torch.from_numpy(pairs.tile2[k]).to(device)
        plain = partial_counts_torch(
            lanes1, lanes2, tile1[:PLAIN_PAIRS].long(),
            tile2[:PLAIN_PAIRS].long(), table, cols_binned=binned,
            direct=direct, chunk_size=chip_smoke.PLAIN_CHUNK,
        )
        for run in builds.values():
            chip_smoke.compare(
                run(lanes1, lanes2, tile1[:PLAIN_PAIRS], tile2[:PLAIN_PAIRS],
                    table, binned, direct),
                plain, chip_smoke.DIRECT_RTOL,
            )
        units = (chip_smoke.unit_weights(lanes1), chip_smoke.unit_weights(lanes2))
        for weights, (rows, cols) in (("real", (lanes1, lanes2)), ("unit", units)):
            parent = builds["parent"](rows, cols, tile1, tile2, table, binned, direct)
            for name, run in builds.items():
                other = run(rows, cols, tile1, tile2, table, binned, direct)
                torch.cuda.synchronize()
                chip_smoke.check(
                    torch.equal(parent, other),
                    f"{label} {weights} weights: {name} differs from the parent",
                )
                del other
            del parent
        mirror = kept_chunk_blocks(
            lanes1, cuda_paircount._device_caps(lanes1),
            cuda_paircount._device_caps(lanes2), tile1, tile2, table,
            cols_binned=binned, direct=direct,
        )
        tracing.reset()
        builds["shipped"](lanes1, lanes2, tile1, tile2, table, binned, direct)
        counted = tracing.snapshot().get(cuda_paircount.KEPT_BLOCKS, 0)
        chip_smoke.check(
            counted == mirror,
            f"{label}: the kernel kept {counted} blocks, the mirror {mirror}",
        )
        blocks = chunk_blocks(
            len(tile1), lanes1.shape[2], counting_width(table.shape[1], direct)
        )
        times = {name: [] for name in builds}
        for name in [*builds, *reversed(builds)]:
            times[name].append(chip_smoke.cuda_ms(
                lambda: builds[name](
                    lanes1, lanes2, tile1, tile2, table, binned, direct
                ),
                REPS,
            ))
        for name, ms in times.items():
            totals[name] += statistics.mean(ms)
        line = ", ".join(
            f"{name} {statistics.mean(ms):.3f} ms "
            f"({' / '.join(f'{t:.3f}' for t in ms)})"
            for name, ms in times.items()
        )
        chip_smoke.log(
            f"[{card}] {label} ({len(tile1)} of {pairs.num_pairs} tile pairs, "
            f"{'K1.3' if direct[3] else 'K1.4'}, binned {binned}, table "
            f"{tuple(table.shape)}): {line}; chunk blocks kept {mirror} of "
            f"{blocks} ({mirror / blocks:.4f}, kernel count = mirror); "
            "bitwise equal to the parent (real and unit weights)"
        )
        del lanes1, lanes2, units, table, tile1, tile2, plain
    chip_smoke.log(f"[{card}] all lists: " + ", ".join(
        f"{name} {ms:.3f} ms" for name, ms in totals.items()))


if __name__ == "__main__":
    main()
