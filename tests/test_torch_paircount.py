"""The port's pair-count engine against the JAX package's, on identical
inputs.

Inputs are built with numpy from a seed through the JAX package (tile
sets, the cap-pruned tile-pair list, the threshold table) and converted
with :mod:`yet_another_wizz_tpu_torch.interop`, so both engines see the
same bytes. The port's plain PyTorch engine (the engine it runs for CPU
tensors) is compared with the JAX XLA engine and the
Pallas kernel (interpreter mode on the CPU). Tolerance ``rtol=1e-6,
atol=1e-6 * max|ref|``: the chord arithmetic is the same, the float32
summation order is not.
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from test_engine import patch_geometry, random_cap_catalog, simple_patches
from yet_another_wizz_tpu.ops.linkage import (
    TilePairs as JaxTilePairs,
    build_linkage,
    build_tile_pairs,
)
from yet_another_wizz_tpu.ops.paircount import (
    count_pairs_tiles as jax_count_pairs_tiles,
)
from yet_another_wizz_tpu.ops.tiles import build_tile_set as jax_build_tile_set
from yet_another_wizz_tpu_torch import interop
from yet_another_wizz_tpu_torch.ops import cuda_paircount
from yet_another_wizz_tpu_torch.utils import tracing
from yet_another_wizz_tpu_torch.ops.paircount import (
    count_pairs_tiles,
    count_pairs_torch,
    pair_block_counts,
)

TILESET_FIELDS = (
    "lane_data", "tile_patch", "tile_center", "tile_radius",
    "patch_tile_start", "patch_tile_stop", "sum_weights", "tile_zmin",
    "tile_zmax", "num_bins", "num_points",
)


@pytest.fixture(autouse=True)
def float_lanes(monkeypatch):
    """The JAX engines upload float lanes, like the port."""
    monkeypatch.setenv("YAWT_LANE_ENCODING", "float")


def assert_counts_close(actual, desired):
    desired = np.asarray(desired)
    assert_allclose(
        actual, desired, rtol=1e-6, atol=1e-6 * np.abs(desired).max()
    )


def convert_tiles(jax_tiles):
    return interop.tileset_from_arrays(
        **{name: getattr(jax_tiles, name) for name in TILESET_FIELDS}
    )


def convert_pairs(jax_pairs):
    return interop.tilepairs_from_arrays(
        jax_pairs.tile1, jax_pairs.tile2, jax_pairs.slot,
        jax_pairs.slot_patches,
    )


def cross_inputs(rng, *, num_bins, num_patches, tile_size, n1=1500, n2=2000):
    """Binned rows against unbinned columns, as in crosscorrelate."""
    xyz1, w1, z1 = random_cap_catalog(rng, n1, num_bins)
    xyz2, w2, _ = random_cap_catalog(rng, n2, num_bins)
    patch1 = simple_patches(xyz1, num_patches, np.random.default_rng(3))
    patch2 = simple_patches(xyz2, num_patches, np.random.default_rng(3))
    ts1 = jax_build_tile_set(
        xyz1, patch1, num_patches, weights=w1, zbins=z1, num_bins=num_bins,
        tile_size=tile_size,
    )
    ts2 = jax_build_tile_set(
        xyz2, patch2, num_patches, weights=w2, tile_size=tile_size
    )
    edges = np.deg2rad(np.tile((0.2, 0.7, 1.0), (num_bins, 1)))
    edges *= np.linspace(1.0, 0.6, num_bins)[:, None]  # per-bin thresholds
    chord2 = ((2 * np.sin(edges / 2)) ** 2).astype(np.float32)
    centers, radii = patch_geometry(xyz1, patch1, num_patches)
    linkage = build_linkage(centers, radii, edges.max() * 1.000001)
    pairs = build_tile_pairs(ts1, ts2, linkage, auto=False)
    return ts1, ts2, pairs, chord2


def port_counts(ts1, ts2, pairs, chord2, backend="auto"):
    return count_pairs_tiles(
        convert_tiles(ts1), convert_tiles(ts2), convert_pairs(pairs), chord2,
        backend=backend, device="cpu",
    )


@pytest.mark.parametrize("tile_size", [64, 512])
def test_plain_engine_matches_xla(rng, tile_size):
    ts1, ts2, pairs, chord2 = cross_inputs(
        rng, num_bins=4, num_patches=8, tile_size=tile_size, n1=3000, n2=6000
    )
    assert pairs.num_pairs > 8 and pairs.num_slots > 1  # multi-slot list
    expected = jax_count_pairs_tiles(
        ts1, ts2, pairs, chord2, backend="xla", mesh="single"
    )
    assert_counts_close(port_counts(ts1, ts2, pairs, chord2, "torch"), expected)


def test_plain_engine_matches_pallas_kernel(rng):
    ts1, ts2, pairs, chord2 = cross_inputs(
        rng, num_bins=3, num_patches=4, tile_size=64
    )
    expected = jax_count_pairs_tiles(
        ts1, ts2, pairs, chord2, backend="pallas", mesh="single"
    )
    assert_counts_close(port_counts(ts1, ts2, pairs, chord2), expected)


def test_single_slot_accumulation(rng):
    """Many tile pairs landing in one output slot must accumulate."""
    num_bins = 2
    xyz1, w1, z1 = random_cap_catalog(rng, 2000, num_bins, cap_deg=3.0)
    xyz2, w2, _ = random_cap_catalog(rng, 2000, num_bins, cap_deg=3.0)
    patches = np.zeros(2000, dtype=int)
    ts1 = jax_build_tile_set(
        xyz1, patches, 1, weights=w1, zbins=z1, num_bins=num_bins,
        tile_size=64,
    )
    ts2 = jax_build_tile_set(xyz2, patches, 1, weights=w2, tile_size=64)
    edges = np.deg2rad(np.tile((0.5, 2.0), (num_bins, 1)))
    chord2 = ((2 * np.sin(edges / 2)) ** 2).astype(np.float32)
    centers, radii = patch_geometry(xyz1, patches, 1)
    linkage = build_linkage(centers, radii, edges.max() * 1.01)
    pairs = build_tile_pairs(ts1, ts2, linkage, auto=False)
    assert pairs.num_slots == 1 and pairs.num_pairs > 100

    expected = jax_count_pairs_tiles(
        ts1, ts2, pairs, chord2, backend="xla", mesh="single"
    )
    assert_counts_close(port_counts(ts1, ts2, pairs, chord2), expected)


def test_empty_slot_rows_are_zero(rng):
    """A linked patch pair whose tile pairs were ALL cap-pruned has a slot
    but no pair-list entries; its row must come back exactly zero."""
    ts1, ts2, pairs, chord2 = cross_inputs(
        rng, num_bins=2, num_patches=4, tile_size=64
    )
    extra = np.array([[0, 1], [1, 0], [2, 3]])
    crafted = JaxTilePairs(
        tile1=pairs.tile1,
        tile2=pairs.tile2,
        slot=pairs.slot,
        slot_patches=np.concatenate([pairs.slot_patches, extra]),
    )
    counts = port_counts(ts1, ts2, crafted, chord2)
    num_real = pairs.num_slots
    assert counts.shape[0] == num_real + 3
    assert_array_equal(counts[num_real:], 0.0)
    assert_counts_close(
        counts[:num_real],
        jax_count_pairs_tiles(ts1, ts2, pairs, chord2, backend="xla",
                              mesh="single"),
    )


def test_interop_preserves_inputs(rng):
    ts1, _, pairs, _ = cross_inputs(rng, num_bins=2, num_patches=4, tile_size=64)
    tiles = convert_tiles(ts1)
    assert tiles.lane_data.tobytes() == ts1.lane_data.tobytes()
    assert tiles.tile_size == 64 and tiles.num_bins == 2
    for name in TILESET_FIELDS[1:-2]:
        assert_array_equal(getattr(tiles, name), getattr(ts1, name))
    converted = convert_pairs(pairs)
    for name in ("tile1", "tile2", "slot", "slot_patches"):
        assert_array_equal(getattr(converted, name), getattr(pairs, name))


def test_wrappers_take_plain_versions_on_cpu(rng):
    """The kernel wrappers refuse CPU tensors; on the CPU the engine's
    chooser takes the plain engine for ``auto`` as for ``torch``, bit for
    bit, and counts no launch."""
    ts1, ts2, pairs, chord2 = cross_inputs(
        rng, num_bins=3, num_patches=4, tile_size=64
    )
    tiles1, tiles2 = convert_tiles(ts1), convert_tiles(ts2)
    port_pairs = convert_pairs(pairs)
    lanes1, lanes2 = tiles1.device_data("cpu"), tiles2.device_data("cpu")
    table = torch.from_numpy(chord2)
    tile1 = torch.from_numpy(pairs.tile1.astype(np.int32))
    tile2 = torch.from_numpy(pairs.tile2.astype(np.int32))
    with pytest.raises(ValueError, match="no pair-count kernel"):
        cuda_paircount.count_pairs_cuda(lanes1, lanes2, port_pairs, table)
    with pytest.raises(ValueError, match="no pair-count kernel"):
        cuda_paircount.paircount_partials(lanes1, lanes2, tile1, tile2, table)
    partial = pair_block_counts(lanes1[tile1.long()], lanes2[tile2.long()], table)
    offsets = torch.zeros(port_pairs.num_slots + 1, dtype=torch.int64)
    with pytest.raises(ValueError, match="no segment-sum kernel"):
        cuda_paircount.segment_sum(
            partial, torch.from_numpy(pairs.slot), offsets, port_pairs.num_slots
        )
    tracing.reset()
    via_auto = count_pairs_tiles(
        tiles1, tiles2, port_pairs, chord2, backend="auto", device="cpu"
    )
    assert not any(k.startswith(cuda_paircount.LAUNCHES) for k in tracing.counters)
    plain = count_pairs_tiles(
        tiles1, tiles2, port_pairs, chord2, backend="torch", device="cpu"
    )
    assert via_auto.tobytes() == plain.tobytes()
    assert torch.equal(
        torch.from_numpy(plain).float(),
        count_pairs_torch(lanes1, lanes2, port_pairs, table),
    )


@pytest.mark.parametrize("chunk_size", [1, 3, 64])
def test_plain_engine_chunking_is_exact(rng, chunk_size):
    """The batch size of the plain engine only bounds its temporaries."""
    ts1, ts2, pairs, chord2 = cross_inputs(
        rng, num_bins=2, num_patches=4, tile_size=64
    )
    tiles1, tiles2 = convert_tiles(ts1), convert_tiles(ts2)
    port_pairs = convert_pairs(pairs)
    reference = count_pairs_tiles(
        tiles1, tiles2, port_pairs, chord2, backend="torch", device="cpu",
        chunk_size=8,
    )
    assert_array_equal(
        count_pairs_tiles(
            tiles1, tiles2, port_pairs, chord2, backend="torch",
            device="cpu", chunk_size=chunk_size,
        ),
        reference,
    )
