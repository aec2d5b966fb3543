"""The audit's flag pass (K2.1) and the widened chunk skip of its CUDA kernel.

The flag kernel (``csrc/paircount.cu``, kernel C) evaluates only the column
chunks in reach of a row chunk widened by the audit band: ``t + band`` in
place of ``t``. That is exact only if no skipped pair is near an edge. Its
triage turns the kept chunk blocks into a work list of (tile pair, row
chunk, column-chunk mask) items, whose plain mirror
(:func:`~yet_another_wizz_tpu_torch.ops.paircount.flag_work_items`) is
held here against the skip: its items cover exactly the kept blocks, a
tile pair without items has flag 0, and tile pairs flagged by an earlier
group of edges get none. Here,
on the CPU, the plain mirror of the skip
(:func:`~yet_another_wizz_tpu_torch.ops.paircount.chunk_keep_mask` with a
band table) drops no valid pair within the band of an edge, on the
hand-packed edge cases of ``torch_chunk_cases.py`` (a pair exactly at ``t +
band`` between tangent caps, and one a float32 ulp beyond it) and on random
clustered tiles with unbinned and binned columns and signed and zero
weights; the flags over the kept chunk blocks alone equal the plain flag
pass over every pair; and the dispatching ``boundary_flags`` takes the
plain version for CPU tensors, launches nothing, and raises for other
devices. The kernel itself is held against the plain version on the card
(``test_torch_cuda.py``, ``chip_smoke.py``).
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import numpy as np
import pytest
import torch

from torch_chunk_cases import (
    ON_BAND,
    band_inputs,
    edge_case_inputs,
    expand_chunks,
    near_pairs,
)
from yet_another_wizz_tpu_torch.ops import cuda_paircount
from yet_another_wizz_tpu_torch.utils import tracing
from yet_another_wizz_tpu_torch.ops.paircount import (
    FLAG_ITEM_CHUNKS,
    audit_band,
    boundary_flags,
    boundary_flags_torch,
    chunk_keep_mask,
    flag_work_items,
)
from yet_another_wizz_tpu_torch.ops.tiles import build_tile_set, chunk_caps

NUM_BINS = 3


def clustered_inputs(seed, *, cols_binned, weights, rel_band=2e-3,
                     tile_size=64):
    """Every tile pair of two tile sets of 64-point tiles drawn around a
    few cluster centers, thresholds of 0.05-0.4 deg per bin and the band
    of ``rel_band`` (the audit's is 1e-6), wide enough that some tile
    pairs are flagged. ``weights``: ``"positive"``, ``"signed"`` (both signs) or ``"zero"``
    (a fifth of the points carry weight 0)."""
    rng = np.random.default_rng(seed)

    def catalog(n):
        centers = rng.normal(size=(6, 3)) * 0.05 + [0.0, 0.0, 1.0]
        xyz = centers[rng.integers(0, len(centers), n)]
        xyz = xyz + rng.normal(scale=np.deg2rad(0.3), size=(n, 3))
        xyz /= np.linalg.norm(xyz, axis=1, keepdims=True)
        w = rng.uniform(0.5, 2.0, n)
        if weights == "signed":
            w *= rng.choice([-1.0, 1.0], n)
        if weights == "zero":
            w[rng.random(n) < 0.2] = 0.0
        return xyz, w, rng.integers(0, NUM_BINS, n)

    def tiles(xyz, w, zbins, binned):
        patches = (xyz[:, 0] > np.median(xyz[:, 0])).astype(int)
        extra = dict(zbins=zbins, num_bins=NUM_BINS) if binned else {}
        return build_tile_set(
            xyz, patches, 2, weights=w, tile_size=tile_size, **extra
        )

    tiles1 = tiles(*catalog(900), binned=True)
    tiles2 = tiles(*catalog(1100), binned=cols_binned)
    edges = np.deg2rad([0.05, 0.15, 0.4]) * np.linspace(1.0, 0.6, NUM_BINS)[:, None]
    table = ((2 * np.sin(edges / 2)) ** 2).astype(np.float32)
    band = audit_band(edges, table, rel_band=rel_band).astype(np.float32)
    tile1, tile2 = np.meshgrid(
        np.arange(tiles1.num_tiles), np.arange(tiles2.num_tiles), indexing="ij"
    )
    return (
        torch.from_numpy(tiles1.lane_data), torch.from_numpy(tiles2.lane_data),
        torch.from_numpy(tile1.ravel().astype(np.int32)),
        torch.from_numpy(tile2.ravel().astype(np.int32)),
        torch.from_numpy(table), torch.from_numpy(band),
    )


def kept_flags(lanes1, lanes2, tile1, tile2, table, band, cols_binned):
    """The flags over the chunk blocks the widened skip keeps, after
    checking that it drops no near pair; also the kept mask."""
    keep = chunk_keep_mask(
        lanes1, chunk_caps(lanes1), chunk_caps(lanes2), tile1, tile2, table,
        cols_binned=cols_binned, band_table=band,
    )
    near = near_pairs(
        lanes1, lanes2, tile1, tile2, table, band, cols_binned=cols_binned
    )
    kept = near & expand_chunks(keep)
    assert not (near & ~kept).any()
    return kept.flatten(1).any(dim=1), keep, near


@pytest.mark.parametrize("beyond", [False, True], ids=["at", "one-ulp-beyond"])
@pytest.mark.parametrize("signed", [False, True], ids=["positive", "signed"])
@pytest.mark.parametrize("cols_binned", [False, True], ids=["cross", "binned"])
def test_widened_skip_on_edge_cases(cols_binned, signed, beyond):
    """Pairs exactly at ``t + band`` between tangent caps are near and
    kept; one float32 ulp beyond, they are not near. Either way the
    skip drops no near pair, and the flags over the kept blocks are the
    plain flag pass's."""
    lanes1, lanes2, tile1, tile2, table = edge_case_inputs(7, signed=signed)
    table, band = band_inputs(table, beyond=beyond)
    flags, keep, near = kept_flags(
        lanes1, lanes2, tile1, tile2, table, band, cols_binned
    )
    for pair, row, col in ON_BAND:
        assert bool(near[pair, row, col]) is not beyond
        assert keep[pair, row // 32, col // 32]
    assert not keep[0, 1].any()  # a row chunk of zero weights
    assert not keep[[0, 2], :, 3].any()  # a column chunk of zero weights
    plain = boundary_flags_torch(
        lanes1, lanes2, tile1.long(), tile2.long(), table, band,
        cols_binned=cols_binned,
    )
    assert torch.equal(flags, plain)
    if not beyond:
        assert plain[[0, 4]].all()


@pytest.mark.parametrize("rel_band", [2e-3, 5e-2])
@pytest.mark.parametrize("weights", ["positive", "signed", "zero"])
@pytest.mark.parametrize("cols_binned", [False, True], ids=["cross", "binned"])
def test_widened_skip_on_clustered_tiles(cols_binned, weights, rel_band):
    inputs = clustered_inputs(
        3, cols_binned=cols_binned, weights=weights, rel_band=rel_band
    )
    flags, keep, _ = kept_flags(*inputs, cols_binned)
    plain = boundary_flags_torch(
        *inputs[:2], inputs[2].long(), inputs[3].long(), *inputs[4:],
        cols_binned=cols_binned,
    )
    assert 0 < int(plain.sum()) < len(plain)
    assert not keep.all()  # the skip drops chunk blocks
    assert torch.equal(flags, plain)
    # the band widens the reach: every block the counting skip keeps is kept
    counting = chunk_keep_mask(
        inputs[0], chunk_caps(inputs[0]), chunk_caps(inputs[1]), inputs[2],
        inputs[3], inputs[4], cols_binned=cols_binned,
    )
    assert not (counting & ~keep).any()


def test_dispatch_takes_the_plain_version_on_the_cpu():
    inputs = clustered_inputs(5, cols_binned=True, weights="signed")
    tracing.reset()
    flags = boundary_flags(*inputs, cols_binned=True)
    plain = boundary_flags_torch(
        *inputs[:2], inputs[2].long(), inputs[3].long(), *inputs[4:],
        cols_binned=True,
    )
    assert flags.dtype == torch.bool and flags.device.type == "cpu"
    assert torch.equal(flags, plain)
    assert not any(k.startswith(cuda_paircount.LAUNCHES) for k in tracing.counters)


def test_no_flag_pass_off_the_cpu_and_the_card():
    lanes = torch.zeros((1, 8, 32), device="meta")
    index = torch.zeros(1, dtype=torch.int32, device="meta")
    table = torch.zeros((1, 2), device="meta")
    with pytest.raises(ValueError, match="no flag pass for device meta"):
        boundary_flags(lanes, lanes, index, index, table, table)
    # the kernel's wrapper takes CUDA tensors only: no fallback
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        cuda_paircount.boundary_flags_cuda(
            torch.zeros((1, 8, 32)), torch.zeros((1, 8, 32)),
            torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
            torch.zeros((1, 2)), torch.zeros((1, 2)),
        )


def items_mask(items, num_pairs, num_chunks):
    """The ``(P, K, K)`` chunk blocks a work list covers."""
    runs = -(-num_chunks // FLAG_ITEM_CHUNKS)
    covered = torch.zeros(
        (num_pairs, num_chunks, runs * FLAG_ITEM_CHUNKS), dtype=torch.bool
    )
    for entry, unit, mask in items.tolist():
        row, run = divmod(unit, runs)
        for bit in range(FLAG_ITEM_CHUNKS):
            if mask >> bit & 1:
                covered[entry, row, run * FLAG_ITEM_CHUNKS + bit] = True
    assert not covered[:, :, num_chunks:].any()
    return covered[:, :, :num_chunks]


def check_work_items(lanes1, lanes2, tile1, tile2, table, band, cols_binned):
    """The work list covers exactly the blocks the widened skip keeps, one
    item per (tile pair, row chunk, run) with a nonzero mask, sorted; the
    tile pairs without items are those with no kept block, and their plain
    flag is 0. Returns the items and the plain flags."""
    caps1, caps2 = chunk_caps(lanes1), chunk_caps(lanes2)
    keep = chunk_keep_mask(
        lanes1, caps1, caps2, tile1, tile2, table,
        cols_binned=cols_binned, band_table=band,
    )
    items = flag_work_items(
        lanes1, caps1, caps2, tile1, tile2, table, band,
        cols_binned=cols_binned,
    )
    assert items.dtype == torch.int64 and items.shape[1] == 3
    assert (items[:, 2] > 0).all()
    order = items[:, 0] * (1 << 16) + items[:, 1]
    assert (order[1:] > order[:-1]).all()  # sorted, no item twice
    assert torch.equal(items_mask(items, *keep.shape[:2]), keep)
    plain = boundary_flags_torch(
        lanes1, lanes2, tile1.long(), tile2.long(), table, band,
        cols_binned=cols_binned,
    )
    without = torch.ones(len(tile1), dtype=torch.bool)
    without[items[:, 0]] = False
    assert torch.equal(without, ~keep.flatten(1).any(dim=1))
    assert not plain[without].any()
    return items, plain


@pytest.mark.parametrize("beyond", [False, True], ids=["at", "one-ulp-beyond"])
@pytest.mark.parametrize("cols_binned", [False, True], ids=["cross", "binned"])
def test_work_items_on_edge_cases(cols_binned, beyond):
    lanes1, lanes2, tile1, tile2, table = edge_case_inputs(7, signed=True)
    table, band = band_inputs(table, beyond=beyond)
    items, plain = check_work_items(
        lanes1, lanes2, tile1, tile2, table, band, cols_binned
    )
    # the pairs at t + band lie in blocks that items cover
    covered = items_mask(items, len(tile1), lanes1.shape[2] // 32)
    for pair, row, col in ON_BAND:
        assert covered[pair, row // 32, col // 32]
    assert not covered[0, 1].any()  # a row chunk of zero weights
    if not beyond:
        assert plain[[0, 4]].all()


@pytest.mark.parametrize("tile_size", [64, 1024], ids=["K=2", "K=32"])
@pytest.mark.parametrize("weights", ["positive", "signed", "zero"])
@pytest.mark.parametrize("cols_binned", [False, True], ids=["cross", "binned"])
def test_work_items_on_clustered_tiles(cols_binned, weights, tile_size):
    """Clustered tiles with 2 chunks per tile (some tile pairs get no
    items) and with 32 (two runs of 16 column chunks per row chunk)."""
    inputs = clustered_inputs(
        3, cols_binned=cols_binned, weights=weights, tile_size=tile_size
    )
    items, plain = check_work_items(*inputs, cols_binned)
    assert plain.any()
    if tile_size == 64:
        assert 0 < len(torch.unique(items[:, 0])) < len(inputs[2])
    else:
        assert (items[:, 1] % 2 == 1).any()  # the second run of a row chunk


def test_work_items_skip_entries_flagged_earlier():
    """A later group of edges gets no items for the tile pairs an earlier
    group flagged, and the same items as without them for the rest."""
    inputs = clustered_inputs(5, cols_binned=False, weights="signed")
    lanes1, lanes2, tile1, tile2, table, band = inputs
    args = (lanes1, chunk_caps(lanes1), chunk_caps(lanes2), tile1, tile2,
            table, band)
    flagged = boundary_flags_torch(
        lanes1, lanes2, tile1.long(), tile2.long(), table[:, -1:], band[:, -1:]
    )
    assert 0 < int(flagged.sum()) < len(flagged)
    every = flag_work_items(*args)
    later = flag_work_items(*args, flags=flagged)
    assert not flagged[later[:, 0]].any()
    assert torch.equal(later, every[~flagged[every[:, 0]]])
