"""Chunk caps and the plain mirror of the cumulative kernel's chunk skip.

The cumulative CUDA kernel skips, per warp, the column chunks that none of
its 32 rows can reach (``csrc/paircount.cu``); that is exact only if no
skipped pair would be counted. Here, on the CPU: every point of nonzero
weight lies inside its chunk's cap; the plain skip rule
(:func:`~yet_another_wizz_tpu_torch.ops.paircount.chunk_keep_mask`, the
kernel's float32 test) never drops a pair whose kernel-arithmetic squared
chord is at or below its row's largest threshold (of an equal bin, with
binned columns), on tile sets of the port, tile sets converted from the
JAX package, and hand-packed edge cases (a pair exactly on a threshold,
tangent caps, padding chunks, signed weights); a plain engine with the
mask applied is ``torch.equal`` to the same engine without it; and the
kernel's wrapper derives the caps from the lanes it is given.
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import gc

import numpy as np
import pytest
import torch

from test_engine import random_cap_catalog, simple_patches
from torch_chunk_cases import (
    block_counts,
    counted_pairs,
    edge_case_inputs,
    expand_chunks,
    unit_weights,
)
from yet_another_wizz_tpu.ops.tiles import build_tile_set as jax_build_tile_set
from yet_another_wizz_tpu_torch import interop
from yet_another_wizz_tpu_torch.ops import cuda_paircount
from yet_another_wizz_tpu_torch.ops import tiles as tile_ops
from yet_another_wizz_tpu_torch.ops.paircount import (
    chunk_keep_mask,
    pair_block_counts,
)
from yet_another_wizz_tpu_torch.ops.tiles import (
    CAP_SLACK,
    CHANNEL_WEIGHT,
    CHANNEL_ZBIN,
    CHUNK_SIZE,
    build_tile_set,
    chunk_caps,
)

TILESET_FIELDS = (
    "lane_data", "tile_patch", "tile_center", "tile_radius",
    "patch_tile_start", "patch_tile_stop", "sum_weights", "tile_zmin",
    "tile_zmax", "num_bins", "num_points",
)
NUM_BINS = 3


def catalog_tiles(source: str, *, binned: bool, signed: bool, seed: int):
    """A tile set of 128-point tiles built by the port or converted from
    the JAX package, with weights of both signs if ``signed``."""
    rng = np.random.default_rng(seed)
    xyz, weights, zbins = random_cap_catalog(rng, 1500, NUM_BINS, cap_deg=3.0)
    if signed:
        weights = weights * rng.choice([-1.0, 1.0], len(weights))
    patches = simple_patches(xyz, 3, np.random.default_rng(seed))
    extra = dict(zbins=zbins, num_bins=NUM_BINS) if binned else {}
    if source == "port":
        return build_tile_set(
            xyz, patches, 3, weights=weights, tile_size=128, **extra
        )
    jax_tiles = jax_build_tile_set(
        xyz, patches, 3, weights=weights, tile_size=128, **extra
    )
    return interop.tileset_from_arrays(
        **{name: getattr(jax_tiles, name) for name in TILESET_FIELDS}
    )


def lanes_and_caps(tiles):
    lanes = torch.from_numpy(tiles.lane_data)
    return lanes, chunk_caps(lanes)


def catalog_inputs(source, *, cols_binned, signed, seed=1):
    """Every tile pair of two tile sets, and per-bin thresholds of
    0.05-0.4 deg (a few dozen neighbours per point)."""
    tiles1 = catalog_tiles(source, binned=True, signed=signed, seed=seed)
    tiles2 = catalog_tiles(
        source, binned=cols_binned, signed=False, seed=seed + 1
    )
    edges = np.deg2rad([0.05, 0.15, 0.4]) * np.linspace(1.0, 0.6, NUM_BINS)[:, None]
    table = torch.from_numpy(((2 * np.sin(edges / 2)) ** 2).astype(np.float32))
    tile1, tile2 = np.meshgrid(
        np.arange(tiles1.num_tiles), np.arange(tiles2.num_tiles), indexing="ij"
    )
    return (
        tiles1, tiles2,
        torch.from_numpy(tile1.ravel().astype(np.int32)),
        torch.from_numpy(tile2.ravel().astype(np.int32)),
        table,
    )


def assert_keeps_counted_pairs(lanes1, lanes2, caps1, caps2, tile1, tile2,
                               table, cols_binned):
    keep = chunk_keep_mask(
        lanes1, caps1, caps2, tile1, tile2, table, cols_binned=cols_binned
    )
    counted = counted_pairs(
        lanes1, lanes2, tile1, tile2, table, cols_binned=cols_binned
    )
    assert counted.any()
    assert not (counted & ~expand_chunks(keep)).any()
    return keep


@pytest.mark.parametrize("signed", [False, True], ids=["positive", "signed"])
@pytest.mark.parametrize("source", ["port", "jax"])
def test_caps_cover_points_of_nonzero_weight(source, signed):
    tiles = catalog_tiles(source, binned=True, signed=signed, seed=3)
    lanes, caps = lanes_and_caps(tiles)
    assert caps.shape == (tiles.num_tiles, 128 // CHUNK_SIZE, 8)
    assert caps.dtype == torch.float32

    data = lanes.double().view(tiles.num_tiles, 8, -1, CHUNK_SIZE)
    xyz = data[:, 0:3] + data[:, 3:6]
    covered = data[:, CHANNEL_WEIGHT] != 0
    assert not covered.all()  # the last tile of a patch is padded
    center = caps[..., :3].double().permute(0, 2, 1)[..., None]
    distance = ((xyz - center) ** 2).sum(dim=1).sqrt()
    radius = caps[..., 3].double()
    assert torch.all(~covered | (distance <= radius[..., None] - CAP_SLACK))
    bins = data[:, CHANNEL_ZBIN]
    assert torch.all(~covered | (bins >= caps[..., 4, None].double()))
    assert torch.all(~covered | (bins <= caps[..., 5, None].double()))
    empty = ~covered.any(dim=-1)
    assert torch.all(torch.isinf(radius[empty]) & (radius[empty] < 0))
    assert torch.all(radius[~empty] >= CAP_SLACK)


def test_port_and_jax_tiles_give_the_same_caps():
    port = catalog_tiles("port", binned=True, signed=True, seed=4)
    jax = catalog_tiles("jax", binned=True, signed=True, seed=4)
    assert np.array_equal(port.lane_data, jax.lane_data)
    assert torch.equal(lanes_and_caps(port)[1], lanes_and_caps(jax)[1])


def test_chunk_caps_need_whole_chunks():
    with pytest.raises(ValueError, match="chunks of 32"):
        chunk_caps(torch.zeros((2, 8, 48)))


@pytest.mark.parametrize("signed", [False, True], ids=["positive", "signed"])
@pytest.mark.parametrize("cols_binned", [False, True], ids=["cross", "binned"])
@pytest.mark.parametrize("source", ["port", "jax"])
def test_keep_mask_keeps_every_counted_pair(source, cols_binned, signed):
    tiles1, tiles2, tile1, tile2, table = catalog_inputs(
        source, cols_binned=cols_binned, signed=signed
    )
    lanes1, caps1 = lanes_and_caps(tiles1)
    lanes2, caps2 = lanes_and_caps(tiles2)
    keep = assert_keeps_counted_pairs(
        lanes1, lanes2, caps1, caps2, tile1, tile2, table, cols_binned
    )
    assert not keep.all()  # the rule drops most chunk pairs


@pytest.mark.parametrize("signed", [False, True], ids=["positive", "signed"])
@pytest.mark.parametrize("cols_binned", [False, True], ids=["cross", "binned"])
def test_keep_mask_on_edge_cases(cols_binned, signed):
    lanes1, lanes2, tile1, tile2, table = edge_case_inputs(7, signed=signed)
    caps1, caps2 = chunk_caps(lanes1), chunk_caps(lanes2)
    keep = assert_keeps_counted_pairs(
        lanes1, lanes2, caps1, caps2, tile1, tile2, table, cols_binned
    )
    # the pair exactly on bin 0's largest threshold, between tangent caps
    counted = counted_pairs(
        lanes1, lanes2, tile1, tile2, table, cols_binned=cols_binned
    )
    assert counted[0, 1, 0] and keep[0, 0, 0]
    # the same on straight lines, where the caps are exactly tangent
    for k in range(4):
        assert counted[4, 32 * k + 1, 32 * k] and keep[4, k, k]
    assert not keep[0, 1].any()  # a row chunk of zero weights
    assert not keep[[0, 2], :, 3].any()  # a column chunk of zero weights
    assert not keep[0, 3].any()  # rows far from every column
    assert torch.isinf(caps1[0, 1, 3]) and caps1[0, 1, 3] < 0


@pytest.mark.parametrize("weights", ["unit", "real"])
@pytest.mark.parametrize("cols_binned", [False, True], ids=["cross", "binned"])
@pytest.mark.parametrize("case", ["edge", "catalog"])
def test_masked_plain_engine_equals_plain_engine(case, cols_binned, weights):
    if case == "edge":
        lanes1, lanes2, tile1, tile2, table = edge_case_inputs(
            8, signed=weights == "real"
        )
    else:
        tiles1, tiles2, tile1, tile2, table = catalog_inputs(
            "port", cols_binned=cols_binned, signed=weights == "real", seed=5
        )
        lanes1 = torch.from_numpy(tiles1.lane_data)
        lanes2 = torch.from_numpy(tiles2.lane_data)
    if weights == "unit":
        lanes1, lanes2 = unit_weights(lanes1), unit_weights(lanes2)
    keep = chunk_keep_mask(
        lanes1, chunk_caps(lanes1), chunk_caps(lanes2), tile1, tile2, table,
        cols_binned=cols_binned,
    )
    inputs = (lanes1, lanes2, tile1, tile2, table)
    plain = block_counts(*inputs, cols_binned=cols_binned)
    masked = block_counts(
        *inputs, cols_binned=cols_binned, pair_mask=expand_chunks(keep)
    )
    assert plain.abs().max() > 0
    assert torch.equal(masked, plain)
    if weights == "unit":  # integer counts: exact in any order
        engine = pair_block_counts(
            lanes1[tile1.long()], lanes2[tile2.long()], table,
            cols_binned=cols_binned,
        )
        assert torch.equal(plain, engine)


def test_wrapper_derives_caps_from_the_lanes():
    """The kernel's wrapper reads no caps from its caller: it derives them
    from the lanes, once, and again after the lanes change in place."""
    lanes = edge_case_inputs(9, signed=True)[0]
    caps = tile_ops._device_caps(lanes)
    assert torch.equal(caps, chunk_caps(lanes))
    assert tile_ops._device_caps(lanes) is caps
    assert cuda_paircount._device_caps is tile_ops._device_caps
    lanes[0, CHANNEL_WEIGHT, :CHUNK_SIZE] = 0.0  # the first chunk now counts nothing
    changed = tile_ops._device_caps(lanes)
    assert torch.equal(changed, chunk_caps(lanes))
    assert torch.isinf(changed[0, 0, 3]) and not torch.isinf(caps[0, 0, 3])
    key = id(lanes)
    del lanes
    gc.collect()
    assert key not in tile_ops._caps
