"""The CUDA pair-count kernels against their plain PyTorch versions.

These tests need an NVIDIA card with the CUDA toolkit (the kernels are
compiled with ``nvcc`` at first use) and skip without one. Run them on the
card with ``python -m pytest tests/test_torch_cuda.py -m gpu``.
"""

import numpy as np
import pytest
import torch

from yet_another_wizz_tpu_torch.ops import cuda_paircount
from yet_another_wizz_tpu_torch.ops.linkage import (
    TilePairs,
    build_linkage,
    build_tile_pairs,
)
from yet_another_wizz_tpu_torch.ops.paircount import (
    count_pairs_tiles,
    partial_counts_torch,
    segment_sum_torch,
)
from yet_another_wizz_tpu_torch.ops.tiles import build_tile_set

pytestmark = pytest.mark.gpu


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda_paircount.build()
    return torch.device("cuda")


def cap_catalog(rng, n, num_bins, cap_deg=20.0):
    """Random weighted points in a spherical cap around the z axis."""
    mu = rng.uniform(np.cos(np.deg2rad(cap_deg)), 1.0, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    s = np.sqrt(1 - mu**2)
    xyz = np.column_stack([s * np.cos(phi), s * np.sin(phi), mu])
    return xyz, rng.uniform(0.5, 2.0, n), rng.integers(0, num_bins, n)


def cross_inputs(rng, *, num_bins=3, num_patches=5, tile_size=512,
                 num_edges=3):
    xyz1, w1, z1 = cap_catalog(rng, 6000, num_bins)
    xyz2, w2, _ = cap_catalog(rng, 9000, num_bins)
    centers = xyz1[rng.choice(len(xyz1), num_patches, replace=False)]
    patch1 = np.argmax(xyz1 @ centers.T, axis=1)
    patch2 = np.argmax(xyz2 @ centers.T, axis=1)
    tiles1 = build_tile_set(
        xyz1, patch1, num_patches, weights=w1, zbins=z1, num_bins=num_bins,
        tile_size=tile_size,
    )
    tiles2 = build_tile_set(
        xyz2, patch2, num_patches, weights=w2, tile_size=tile_size
    )
    edges = np.deg2rad(np.geomspace(0.1, 1.5, num_edges))
    edges = np.tile(edges, (num_bins, 1)) * np.linspace(
        1.0, 0.7, num_bins
    )[:, None]
    table = ((2 * np.sin(edges / 2)) ** 2).astype(np.float32)
    radii = np.full(num_patches, np.deg2rad(25.0))
    linkage = build_linkage(centers, radii, edges.max())
    pairs = build_tile_pairs(tiles1, tiles2, linkage, auto=False)
    return tiles1, tiles2, pairs, table


def assert_close(actual, desired):
    atol = 1e-6 * desired.abs().max().item()
    torch.testing.assert_close(actual, desired, rtol=1e-6, atol=atol)


@pytest.mark.parametrize("num_edges", [2, 5, 19])
def test_kernels_match_plain_versions(device, num_edges):
    rng = np.random.default_rng(num_edges)
    tiles1, tiles2, pairs, table = cross_inputs(rng, num_edges=num_edges)
    lanes1 = tiles1.device_data(device)
    lanes2 = tiles2.device_data(device)
    table_dev = torch.from_numpy(table).to(device)
    tile1 = torch.from_numpy(pairs.tile1).to(device)
    tile2 = torch.from_numpy(pairs.tile2).to(device)
    slot = torch.from_numpy(pairs.slot.astype(np.int64)).to(device)
    offsets = torch.from_numpy(
        np.searchsorted(pairs.slot, np.arange(pairs.num_slots + 1))
    ).to(device)

    partial = cuda_paircount.paircount_partials(
        lanes1, lanes2, tile1, tile2, table_dev
    )
    plain_partial = partial_counts_torch(
        lanes1, lanes2, tile1.long(), tile2.long(), table_dev
    )
    assert_close(partial, plain_partial)

    out = cuda_paircount.segment_sum(partial, slot, offsets, pairs.num_slots)
    assert_close(out, segment_sum_torch(partial, slot, pairs.num_slots))
    torch.cuda.synchronize()


def test_kernels_are_deterministic(device):
    tiles1, tiles2, pairs, table = cross_inputs(np.random.default_rng(5))
    runs = [
        count_pairs_tiles(
            tiles1, tiles2, pairs, table, backend="cuda", device=device
        )
        for _ in range(2)
    ]
    assert runs[0].tobytes() == runs[1].tobytes()


def test_empty_slots_are_zero_and_launches_counted(device):
    tiles1, tiles2, pairs, table = cross_inputs(np.random.default_rng(6))
    extra = np.array([[0, 1], [1, 0]])
    crafted = TilePairs(
        tile1=pairs.tile1, tile2=pairs.tile2, slot=pairs.slot,
        slot_patches=np.concatenate([pairs.slot_patches, extra]),
    )
    cuda_paircount.reset_launch_counts()
    counts = count_pairs_tiles(
        tiles1, tiles2, crafted, table, backend="cuda", device=device
    )
    assert cuda_paircount.launch_counts == {
        "paircount_partials": 1, "paircount_segment_sum": 1,
    }
    assert np.all(counts[pairs.num_slots:] == 0.0)
    plain = count_pairs_tiles(
        tiles1, tiles2, pairs, table, backend="torch", device=device
    )
    np.testing.assert_allclose(
        counts[: pairs.num_slots], plain,
        rtol=1e-6, atol=1e-6 * np.abs(plain).max(),
    )
