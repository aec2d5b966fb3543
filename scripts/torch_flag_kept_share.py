#!/usr/bin/env python3
"""What the flag kernel's triage keeps on the chip smoke run's lists.

Builds the inputs of ``chip_smoke.py::flag_check`` (the benchmark's mock
catalogs, 200k / 500k / 1M points, 64 patches, 11 bins; the headline DD
and RD lists and the w_ss DD list; the audit's band) and counts, with the
plain mirrors of ``ops/paircount.py``, on the CPU:

- the chunk blocks the reach rule keeps (``chunk_keep_mask`` with the
  band: the caps lie within ``sqrt(max t + band) + r_row + r_col``), the
  work items of the triage (``flag_work_items``: row chunks that keep any
  block) and the entries it leaves without items (their flag is 0);
- the columns of the kept blocks that the evaluation's column test keeps
  (``csrc/paircount.cu::needed_columns``: nonzero weight, the column's hi
  position within the row chunk's reach of its cap's center, with binned
  columns a bin in the chunk's bin range), and the quads of 4 columns that
  hold one (the evaluation's unit);
- the blocks a band-aware rule would keep: some edge ``e`` of the group
  whose band ``[t - band, t + band]``, over the chunk's rows of nonzero
  weight, meets the caps' chord interval ``[D - r_row - r_col, D + r_row +
  r_col]``, ``D`` the distance of the caps' centers; its share of the
  reach rule's blocks.

It is a count, not a time, so it runs on any device::

    python3 scripts/torch_flag_kept_share.py [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

COUNTS = ("cross DD", "cross RD", "auto DD")
BATCH = 4096
"""Tile pairs per batch of the masks (a few (BATCH, 16, 16, 3) float32
temporaries)."""


def band_keep_mask(lanes1, caps1, caps2, tile1, tile2, table, band, *,
                   cols_binned):
    """``(P, K, K)`` bool: the band-aware rule, per edge, in float32. The
    reach rule's test with ``t + band`` of edge ``e`` alone (over the
    chunk's rows of nonzero weight, the largest), and the chord interval's
    outer end ``D + r_row + r_col`` at or beyond ``sqrt(t - band)`` (the
    smallest), so that no pair of the block lies closer than every band."""
    import torch

    from yet_another_wizz_tpu_torch.ops.paircount import chunk_keep_mask
    from yet_another_wizz_tpu_torch.ops.tiles import (
        CHANNEL_WEIGHT,
        CHANNEL_ZBIN,
        CHUNK_SIZE,
    )

    num_tiles, _, tile_size = lanes1.shape
    tile1, tile2 = tile1.long(), tile2.long()
    bins = lanes1[:, CHANNEL_ZBIN].long().clamp(0, table.shape[0] - 1)
    covered = (lanes1[:, CHANNEL_WEIGHT] != 0).view(
        num_tiles, tile_size // CHUNK_SIZE, CHUNK_SIZE
    )
    row_caps = caps1[tile1][:, :, None, :]
    col_caps = caps2[tile2][:, None, :, :]
    d = row_caps[..., :3] - col_caps[..., :3]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    keep = torch.zeros(d2.shape, dtype=torch.bool)
    for e in range(table.shape[1]):
        edge = slice(e, e + 1)
        outer = chunk_keep_mask(
            lanes1, caps1, caps2, tile1, tile2, table[:, edge],
            cols_binned=cols_binned, band_table=band[:, edge],
        )
        lower = (table[:, e] - band[:, e])[bins].view(covered.shape)
        lower = torch.where(covered, lower, float("inf")).amin(dim=2)
        # the chord interval's outer end reaches sqrt(lower): a limit <= 0
        # is always reached
        inner = lower.clamp(min=0).sqrt() - caps1[..., 3]  # (N1, K)
        limit = inner[tile1][:, :, None] - col_caps[..., 3]
        keep |= outer & ((limit <= 0) | (d2 >= limit * limit))
    return keep


def needed_columns(lanes1, lanes2, caps1, tile1, tile2, keep, table, band, *,
                   cols_binned):
    """``(columns, quads)``: of the columns of the kept blocks, those the
    evaluation's column test keeps, and those in a quad of 4 that holds
    one, in the kernel's float32 operations."""
    from yet_another_wizz_tpu_torch.ops.paircount import chunk_reach
    from yet_another_wizz_tpu_torch.ops.tiles import (
        CHANNEL_WEIGHT,
        CHANNEL_ZBIN,
        CHUNK_SIZE,
    )

    num_pairs, num_chunks, _ = keep.shape
    cols = lanes2[tile2.long()].view(num_pairs, 8, num_chunks, CHUNK_SIZE)
    row_caps = caps1[tile1.long()]  # (P, K, 8)
    reach = chunk_reach(lanes1, caps1, table, band)[tile1.long()]  # (P, K)
    d = row_caps[:, :, None, None, :3] - cols[:, None, :3].permute(0, 1, 3, 4, 2)
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    limit = reach[:, :, None, None]
    need = (limit >= 0) & (d2 <= limit * limit)  # (P, K rows, K cols, C)
    need &= (cols[:, None, CHANNEL_WEIGHT] != 0)
    if cols_binned:
        bins = cols[:, None, CHANNEL_ZBIN]
        need &= ~((bins < row_caps[:, :, None, None, 4])
                  | (row_caps[:, :, None, None, 5] < bins))
    need &= keep[..., None]
    quads = need.view(*need.shape[:3], CHUNK_SIZE // 4, 4).any(dim=4)
    return int(need.sum()), 4 * int(quads.sum())


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cpu")
    args = parser.parse_args()

    import numpy as np
    import torch

    from yet_another_wizz_tpu_torch.catalog import Catalog
    from yet_another_wizz_tpu_torch.config import Configuration
    from yet_another_wizz_tpu_torch.correlation.measurements import PatchLinkage
    from yet_another_wizz_tpu_torch.examples import generate_mock_data
    from yet_another_wizz_tpu_torch.ops.paircount import (
        audit_band,
        chunk_keep_mask,
        flag_work_items,
    )
    from yet_another_wizz_tpu_torch.ops.tiles import chunk_caps

    device = torch.device(args.device)
    mock = generate_mock_data(
        num_reference=chip_smoke.NUM_REFERENCE,
        num_unknown=chip_smoke.NUM_UNKNOWN,
        num_randoms=chip_smoke.NUM_RANDOMS, seed=chip_smoke.SEED,
    )
    reference = Catalog.from_arrays(
        **mock["reference"], degrees=False, patch_num=chip_smoke.NUM_PATCHES,
        device=device,
    )
    centers = reference.get_centers()
    catalogs = (reference, *(
        Catalog.from_arrays(
            **mock[name], degrees=False, patch_centers=centers, device=device
        )
        for name in ("unknown", "randoms")
    ))
    links = PatchLinkage.from_catalogs(
        Configuration.create(**chip_smoke.CONFIG), *catalogs
    )
    table_np = np.ascontiguousarray(links.edges.chord2_table, np.float32)
    table = torch.from_numpy(table_np).to(device)
    band = torch.from_numpy(
        audit_band(links.edges.edges, table_np).astype(np.float32)
    ).to(device)
    for count in COUNTS:
        tiles1, tiles2, pairs = chip_smoke.engine_inputs(links, catalogs, count)
        lanes1, lanes2 = tiles1.device_data(device), tiles2.device_data(device)
        caps1, caps2 = chunk_caps(lanes1), chunk_caps(lanes2)
        tile1 = torch.from_numpy(pairs.tile1.astype(np.int64)).to(device)
        tile2 = torch.from_numpy(pairs.tile2.astype(np.int64)).to(device)
        binned = tiles2.binned
        blocks = kept = tight = items = idle = columns = quads = 0
        for start in range(0, len(tile1), BATCH):
            index = (tile1[start:start + BATCH], tile2[start:start + BATCH])
            args_ = (lanes1, caps1, caps2, *index, table)
            keep = chunk_keep_mask(*args_, cols_binned=binned, band_table=band)
            band_keep = band_keep_mask(*args_, band, cols_binned=binned)
            if (band_keep & ~keep).any():
                raise RuntimeError("the band-aware rule keeps a dropped block")
            work = flag_work_items(*args_, band, cols_binned=binned)
            need, in_quads = needed_columns(
                lanes1, lanes2, caps1, *index, keep, table, band,
                cols_binned=binned,
            )
            columns += need
            quads += in_quads
            blocks += keep.numel()
            kept += int(keep.sum())
            tight += int(band_keep.sum())
            items += len(work)
            idle += len(index[0]) - len(torch.unique(work[:, 0]))
        print(
            f"{count}: {len(tile1)} tile pairs, table {tuple(table.shape)}, "
            f"binned columns {binned}: reach rule keeps {kept} of {blocks} "
            f"chunk blocks ({kept / blocks:.4f}); {items} work items "
            f"({items / len(tile1):.2f} per entry), {idle} entries without "
            f"items ({idle / len(tile1):.4f}); the column test keeps "
            f"{columns / (32 * kept):.4f} of the kept blocks' columns "
            f"({quads / (32 * kept):.4f} in quads); the band-aware rule keeps "
            f"{tight} ({tight / blocks:.4f}), {tight / kept:.4f} of the reach "
            "rule's blocks", flush=True,
        )


if __name__ == "__main__":
    main()
