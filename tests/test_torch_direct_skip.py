"""The chunk skip of the direct pair-count kernels (K1.3, K1.4) in its plain
mirror, on the CPU.

The direct kernels evaluate only the 32 x 32 blocks of a tile pair that a
row chunk can reach, by the cumulative kernels' rule over the launch's
counting edges (``csrc/paircount.cu``, (d) of kernel A); the kernels run
only on the card (``test_torch_cuda.py``). Here, with the small-angle and
the arcsine index, unbinned and binned columns:

- the rule's mirror (``chunk_keep_mask`` over the counting columns) keeps
  every pair that a counting edge of a direct table can count, and drops
  some blocks;
- the mirror's sums and the block counters read only a combined table's
  counting columns, never its parameter block, and count one launch per
  group of 16 counting edges;
- a direct count through either plain engine adds ``engine.chunk_blocks``
  and ``engine.chunk_blocks_kept`` equal to the mirror's sums.
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import pytest
import torch

from torch_chunk_cases import counted_pairs, expand_chunks
from torch_direct_cases import direct_inputs
from yet_another_wizz_tpu_torch.ops.gweight import counting_width
from yet_another_wizz_tpu_torch.ops.paircount import (
    MAX_EDGES_PER_LAUNCH,
    chunk_keep_mask,
    count_chunk_blocks_plain,
    count_pairs_tiles,
    kept_chunk_blocks,
)
from yet_another_wizz_tpu_torch.ops.tiles import CHUNK_SIZE, chunk_caps
from yet_another_wizz_tpu_torch.utils import tracing

GRIDS = pytest.mark.parametrize("grid", ["small_angle", "arcsine"])
BINNED = pytest.mark.parametrize("cols_binned", [False, True], ids=["cross", "binned"])


def tensors(tiles1, tiles2, pairs, table, direct):
    """A count's lanes, caps, pair indices, combined table and direct
    specification as tensors."""
    lanes1 = torch.from_numpy(tiles1.lane_data)
    lanes2 = torch.from_numpy(tiles2.lane_data)
    return (
        lanes1, lanes2, chunk_caps(lanes1), chunk_caps(lanes2),
        torch.from_numpy(pairs.tile1).long(), torch.from_numpy(pairs.tile2).long(),
        torch.from_numpy(table), direct,
    )


def launch_tables(table, direct):
    """The counting columns of each launch of a combined table."""
    num_edges = counting_width(table.shape[1], direct)
    return [
        table[:, edge0:min(edge0 + MAX_EDGES_PER_LAUNCH, num_edges)]
        for edge0 in range(0, num_edges, MAX_EDGES_PER_LAUNCH)
    ]


def mirror_kept(lanes1, caps1, caps2, tile1, tile2, table, direct, cols_binned):
    return sum(
        int(chunk_keep_mask(
            lanes1, caps1, caps2, tile1, tile2, launch, cols_binned=cols_binned
        ).sum())
        for launch in launch_tables(table, direct)
    )


@BINNED
@GRIDS
def test_mirror_keeps_every_pair_a_direct_edge_counts(grid, cols_binned):
    lanes1, lanes2, caps1, caps2, tile1, tile2, table, direct = tensors(
        *direct_inputs(grid, cols_binned)
    )
    (launch,) = launch_tables(table, direct)
    keep = chunk_keep_mask(
        lanes1, caps1, caps2, tile1, tile2, launch, cols_binned=cols_binned
    )
    counted = counted_pairs(
        lanes1, lanes2, tile1, tile2, launch, cols_binned=cols_binned
    )
    assert counted.any()
    assert not (counted & ~expand_chunks(keep)).any()
    assert 0 < keep.double().mean() < 1


@pytest.mark.parametrize("grid", ["small_angle", "arcsine", "many"])
def test_blocks_read_only_the_counting_columns(grid):
    lanes1, lanes2, caps1, caps2, tile1, tile2, table, direct = tensors(
        *direct_inputs(grid, False)
    )
    num_edges = counting_width(table.shape[1], direct)
    launches = -(-num_edges // MAX_EDGES_PER_LAUNCH)
    assert launches == (2 if grid == "many" else 1)
    assert -(-table.shape[1] // MAX_EDGES_PER_LAUNCH) > launches
    # parameters beyond every squared chord: read as thresholds, they would
    # keep every block
    loud = table.clone()
    loud[:, num_edges:] = 4.0
    kept = kept_chunk_blocks(
        lanes1, caps1, caps2, tile1, tile2, table, direct=direct
    )
    assert kept == mirror_kept(
        lanes1, caps1, caps2, tile1, tile2, table, direct, False
    )
    assert kept_chunk_blocks(
        lanes1, caps1, caps2, tile1, tile2, loud, direct=direct
    ) == kept
    tracing.reset()
    count_chunk_blocks_plain(lanes1, lanes2, tile1, tile2, loud, direct=direct)
    blocks = launches * len(tile1) * (lanes1.shape[2] // CHUNK_SIZE) ** 2
    assert tracing.counters["engine.chunk_blocks"] == blocks
    assert tracing.counters["engine.chunk_blocks_kept"] == kept
    assert 0 < kept < blocks


@pytest.mark.parametrize("backend", ["auto", "torch"])
@BINNED
@GRIDS
def test_direct_count_adds_the_mirrors_blocks(grid, cols_binned, backend):
    inputs = direct_inputs(grid, cols_binned)
    tiles1, tiles2, pairs, table, direct = inputs
    lanes1, _, caps1, caps2, tile1, tile2, table_t, _ = tensors(*inputs)
    tracing.reset()
    counts = count_pairs_tiles(
        tiles1, tiles2, pairs, table, backend=backend, device="cpu",
        direct=direct,
    )
    blocks = tracing.counters["engine.chunk_blocks"]
    kept = tracing.counters["engine.chunk_blocks_kept"]
    assert blocks == pairs.num_pairs * (tiles1.tile_size // CHUNK_SIZE) ** 2
    assert kept == mirror_kept(
        lanes1, caps1, caps2, tile1, tile2, table_t, direct, cols_binned
    )
    assert 0 < kept < blocks
    assert counts.max() > 0
