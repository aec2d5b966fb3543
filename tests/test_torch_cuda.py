"""The CUDA pair-count kernels against their plain PyTorch versions.

These tests need an NVIDIA card with the CUDA toolkit (the kernels are
compiled with ``nvcc`` at first use) and skip without one. Run them on the
card with ``python -m pytest tests/test_torch_cuda.py -m gpu``. Every
variant of kernel A is covered: cumulative (K1.1) and binned columns
(K1.2), direct counting with the small-angle (K1.3) and arcsine (K1.4)
index, each with unbinned and binned columns, and signed weights (K1.5),
and direct counting with more than 16 below/above entries per bin.
Cumulative variants agree with the plain version to 1e-6, direct ones to
1e-5: a 1-ulp difference in ``logf`` moves a pair within ~1e-7 of a
sub-edge into the neighbouring sub-interval. Kernel B is held against
the plain segment sum on long runs, empty slots, a single slot and rows
wider than one block. The cumulative variants skip the column chunks that
no row of a warp reaches; with unit weights (integer counts, exact in any
order) they are ``torch.equal`` to the plain version, on hand-packed edge
cases (``torch_chunk_cases.py``: a pair exactly on a threshold between
tangent caps, padding chunks) and on catalog tiles, so a wrongly skipped
pair shows. The blocked measurement path on the card (lanes uploaded on a
side stream, counts accumulated on the device) equals the in-memory path.
The audit's flag pass on the card runs the flag kernel (kernel C: reach,
triage, evaluation, one launch each per group of 16 edges), whose
flags are ``torch.equal`` to the plain version's on the cross and
binned-column lists, signed weights, more than 16 edges (also where a
later group meets tile pairs an earlier one flagged), lists where every
tile pair is flagged and where none is, the chunk edge
cases with a pair exactly at ``t + band`` and one a float32 ulp beyond it,
the engineered on-edge pair of ``torch_audit_cases.py`` and the streamed
windows of host-gathered lanes; its reach and its work list equal their
plain mirrors (``chunk_reach``, ``flag_work_items``); the audit repairs
that pair's flip on the card, in memory and blocked, through the kernel.
After ``Catalog.build_trees`` on the card, a measurement uploads no lanes,
derives no chunk caps and builds no tile set.
"""

import collections

import numpy as np
import pytest
import torch

from torch_chunk_cases import band_inputs, edge_case_inputs, unit_weights
from yet_another_wizz_tpu_torch.cosmology import new_scales
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
from yet_another_wizz_tpu_torch.ops.thresholds import build_angular_edges
from yet_another_wizz_tpu_torch.ops.tiles import build_tile_set
from yet_another_wizz_tpu_torch.utils import tracing

pytestmark = pytest.mark.gpu


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda_paircount.build()
    return torch.device("cuda")


def launched() -> collections.Counter:
    """The kernel launches counted since the counters' last reset, by
    variant (0 for a variant that did not launch)."""
    prefix = cuda_paircount.LAUNCHES
    return collections.Counter({
        name[len(prefix):]: n for name, n in tracing.counters.items()
        if name.startswith(prefix)
    })


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


def assert_close(actual, desired, rtol=1e-6):
    atol = rtol * desired.abs().max().item()
    torch.testing.assert_close(actual, desired, rtol=rtol, atol=atol)


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
    tracing.reset()
    counts = count_pairs_tiles(
        tiles1, tiles2, crafted, table, backend="cuda", device=device
    )
    counted = launched()
    assert counted == {"paircount_partials": 1, "paircount_segment_sum": 1}
    assert np.all(counts[pairs.num_slots:] == 0.0)
    plain = count_pairs_tiles(
        tiles1, tiles2, pairs, table, backend="torch", device=device
    )
    np.testing.assert_allclose(
        counts[: pairs.num_slots], plain,
        rtol=1e-6, atol=1e-6 * np.abs(plain).max(),
    )


VARIANTS = {
    # name: (scales of the direct grid or None, unit)
    "cumulative": None,
    "direct": (([0.05, 0.12, 0.3], [0.2, 0.5, 1.0]), "deg"),
    "arcsine": (([0.05, 0.4], [0.5, 1.35]), "rad"),
    # ten overlapping scales: 18 above-entries per bin, 20 counting edges
    "many": (
        (
            [0.05, 0.061, 0.0745, 0.0909, 0.1109, 0.1353, 0.1651, 0.2015,
             0.2458, 0.3],
            [0.6, 0.6859, 0.7841, 0.8963, 1.0246, 1.1712, 1.3389, 1.5305,
             1.7496, 2.0],
        ),
        "deg",
    ),
}


def variant_inputs(rng, variant, cols_binned, *, num_bins=3, num_patches=5):
    """Tiles with signed row weights, binned or unbinned columns, and the
    table of the variant."""
    xyz1, _, z1 = cap_catalog(rng, 5000, num_bins)
    xyz2, w2, z2 = cap_catalog(rng, 7000, num_bins)
    w1 = rng.normal(0.1, 0.3, len(xyz1))  # kappa-like: signed
    centers = xyz1[rng.choice(len(xyz1), num_patches, replace=False)]
    patch1 = np.argmax(xyz1 @ centers.T, axis=1)
    patch2 = np.argmax(xyz2 @ centers.T, axis=1)
    tiles1 = build_tile_set(
        xyz1, patch1, num_patches, weights=w1, zbins=z1, num_bins=num_bins,
    )
    extra = dict(zbins=z2, num_bins=num_bins) if cols_binned else {}
    tiles2 = build_tile_set(xyz2, patch2, num_patches, weights=w2, **extra)
    if VARIANTS[variant] is None:
        _, _, _, table = cross_inputs(rng, num_bins=num_bins, num_edges=3)
        direct = None
        max_angle = float(np.max(2 * np.arcsin(np.sqrt(table) / 2)))
    else:
        (rmin, rmax), unit = VARIANTS[variant]
        edges = build_angular_edges(
            new_scales(rmin, rmax, unit=unit), np.linspace(0.3, 0.8, num_bins),
            weight_scale=-1.0, weight_res=24, counting="direct",
        )
        table = edges.direct.combined_table()
        direct = edges.direct.spec
        assert direct[3] is (variant != "arcsine")
        assert (max(direct[1:3]) > 16) is (variant == "many")
        max_angle = edges.max_angle
    radii = np.full(num_patches, np.deg2rad(25.0))
    linkage = build_linkage(centers, radii, max_angle * 1.000001)
    pairs = build_tile_pairs(tiles1, tiles2, linkage, auto=False)
    return tiles1, tiles2, pairs, table, direct


@pytest.mark.parametrize("cols_binned", [False, True], ids=["cross", "binned"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variants_match_plain_versions(device, variant, cols_binned):
    rng = np.random.default_rng(11)
    tiles1, tiles2, pairs, table, direct = variant_inputs(
        rng, variant, cols_binned
    )
    assert pairs.num_pairs > 0
    lanes1 = tiles1.device_data(device)
    lanes2 = tiles2.device_data(device)
    table_dev = torch.from_numpy(table).to(device)
    k = slice(0, 512)
    tile1 = torch.from_numpy(pairs.tile1[k]).to(device)
    tile2 = torch.from_numpy(pairs.tile2[k]).to(device)
    kwargs = dict(cols_binned=cols_binned, direct=direct)

    tracing.reset()
    first = cuda_paircount.paircount_partials(
        lanes1, lanes2, tile1, tile2, table_dev, **kwargs
    )
    second = cuda_paircount.paircount_partials(
        lanes1, lanes2, tile1, tile2, table_dev, **kwargs
    )
    plain = partial_counts_torch(
        lanes1, lanes2, tile1.long(), tile2.long(), table_dev, **kwargs
    )
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    name = cuda_paircount.variant_name(cols_binned, direct)
    launches = -(-first.shape[2] // cuda_paircount.MAX_EDGES_PER_LAUNCH)
    assert launched()[name] == 2 * launches
    assert plain.abs().max() > 0 and (plain < 0).any()  # signed weights
    assert_close(first, plain, rtol=1e-6 if direct is None else 1e-5)


def test_binned_direct_engine_matches_plain_engine(device):
    tiles1, tiles2, pairs, table, direct = variant_inputs(
        np.random.default_rng(12), "direct", True
    )
    kernel = count_pairs_tiles(
        tiles1, tiles2, pairs, table, backend="cuda", device=device,
        direct=direct,
    )
    plain = count_pairs_tiles(
        tiles1, tiles2, pairs, table, backend="torch", device=device,
        direct=direct,
    )
    np.testing.assert_allclose(
        kernel, plain, rtol=1e-5, atol=1e-5 * np.abs(plain).max()
    )


@pytest.mark.parametrize(
    "runs, width",
    [
        ([2000, 0, 1500, 1, 0], 44),  # long runs and empty slots
        ([1777], 22),  # a single slot
        ([0, 0], 22),  # no entries at all
        ([300, 2, 0, 41], 300),  # rows wider than one block
    ],
)
def test_segment_sum_matches_plain_version(device, runs, width):
    gen = torch.Generator(device=device).manual_seed(len(runs) * width)
    num_slots = len(runs)
    slot = torch.repeat_interleave(
        torch.arange(num_slots, device=device),
        torch.tensor(runs, device=device),
    )
    offsets = torch.zeros(num_slots + 1, dtype=torch.int64, device=device)
    offsets[1:] = torch.cumsum(torch.tensor(runs, device=device), 0)
    partial = torch.rand(
        (len(slot), 1, width), generator=gen, device=device
    ) - 0.25
    tracing.reset()
    first = cuda_paircount.segment_sum(partial, slot, offsets, num_slots)
    second = cuda_paircount.segment_sum(partial, slot, offsets, num_slots)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert launched()["paircount_segment_sum"] == 2
    # against the plain version in float64: the kernel sums in another
    # order than list order, and over runs this long two float32 orders
    # differ by more than the tolerance
    expected = segment_sum_torch(partial.double(), slot, num_slots)
    assert_close(first.double(), expected)
    assert torch.all(first[torch.tensor(runs, device=device) == 0] == 0.0)


def test_entry_layout_too_large_for_shared_memory_is_refused(device):
    """The direct kernel holds its weight table and entries in shared
    memory; a grid too fine for one block raises instead of falling back."""
    rng = np.random.default_rng(13)
    tiles1, tiles2, pairs, _, _ = variant_inputs(rng, "direct", False)
    (rmin, rmax), unit = VARIANTS["direct"]
    edges = build_angular_edges(
        new_scales(rmin, rmax, unit=unit), np.linspace(0.3, 0.8, 3),
        weight_scale=-1.0, weight_res=20_000, counting="direct",
    )
    table = torch.from_numpy(edges.direct.combined_table()).to(device)
    k = slice(0, 4)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_paircount.paircount_partials(
            tiles1.device_data(device), tiles2.device_data(device),
            torch.from_numpy(pairs.tile1[k]).to(device),
            torch.from_numpy(pairs.tile2[k]).to(device), table,
            direct=edges.direct.spec,
        )


def cumulative_pair(device, lanes1, lanes2, tile1, tile2, table, cols_binned):
    """K1.1 / K1.2 on the card, twice, and the plain version."""
    lanes1, lanes2 = lanes1.to(device), lanes2.to(device)
    tile1, tile2, table = tile1.to(device), tile2.to(device), table.to(device)
    runs = [
        cuda_paircount.paircount_partials(
            lanes1, lanes2, tile1, tile2, table, cols_binned=cols_binned
        )
        for _ in range(2)
    ]
    plain = partial_counts_torch(
        lanes1, lanes2, tile1.long(), tile2.long(), table,
        cols_binned=cols_binned,
    )
    torch.cuda.synchronize()
    return runs, plain


@pytest.mark.parametrize("weights", ["unit", "signed"])
@pytest.mark.parametrize("cols_binned", [False, True], ids=["cross", "binned"])
def test_chunk_skip_on_edge_cases(device, cols_binned, weights):
    """A pair exactly on its row's largest threshold between tangent caps,
    padding chunks on top of counted points, far chunks: with unit weights
    bit for bit the plain version, with signed weights within 1e-6."""
    lanes1, lanes2, tile1, tile2, table = edge_case_inputs(
        17, signed=weights == "signed"
    )
    if weights == "unit":
        lanes1, lanes2 = unit_weights(lanes1), unit_weights(lanes2)
    (first, second), plain = cumulative_pair(
        device, lanes1, lanes2, tile1, tile2, table, cols_binned
    )
    assert torch.equal(first, second)
    assert plain.abs().max() > 0
    if weights == "unit":
        assert torch.equal(first, plain)
    else:
        assert (plain < 0).any()
        assert_close(first, plain)


@pytest.mark.parametrize("cols_binned", [False, True], ids=["cross", "binned"])
def test_chunk_skip_on_catalog_tiles_with_unit_weights(device, cols_binned):
    rng = np.random.default_rng(21)
    tiles1, tiles2, pairs, table, _ = variant_inputs(
        rng, "cumulative", cols_binned
    )
    lanes1 = unit_weights(torch.from_numpy(tiles1.lane_data))
    lanes2 = unit_weights(torch.from_numpy(tiles2.lane_data))
    (first, second), plain = cumulative_pair(
        device, lanes1, lanes2, torch.from_numpy(pairs.tile1),
        torch.from_numpy(pairs.tile2), torch.from_numpy(table), cols_binned,
    )
    assert torch.equal(first, second)
    assert plain.max() > 0
    assert torch.equal(first, plain)


def test_chunk_skip_follows_lanes_changed_in_place(device):
    """The wrapper derives the chunk caps from the lanes it is given: after
    the lanes change in place (weights set where there were none, points
    moved), the kernel counts what the plain version counts."""
    lanes1, lanes2, tile1, tile2, table = (
        t.to(device) for t in edge_case_inputs(18, signed=False)
    )
    lanes1, lanes2 = unit_weights(lanes1), unit_weights(lanes2)
    for step in range(3):
        if step == 1:  # a padding chunk of columns on top of counted rows
            lanes2[0, 6, 3 * 32:] = 1.0
        if step == 2:  # the far row chunk onto the counted columns
            lanes1[0, :6, 3 * 32:] = lanes1[0, :6, 2 * 32:3 * 32]
        kernel = cuda_paircount.paircount_partials(
            lanes1, lanes2, tile1, tile2, table
        )
        plain = partial_counts_torch(
            lanes1, lanes2, tile1.long(), tile2.long(), table
        )
        torch.cuda.synchronize()
        assert torch.equal(kernel, plain), step


@pytest.mark.parametrize("shape", ["cross", "auto"])
def test_blocked_path_matches_in_memory_on_the_card(device, monkeypatch, shape):
    """The blocked path on the card (side-stream uploads, device
    accumulation) equals the in-memory path on the card, is bitwise
    deterministic, and equals its host-scatter mode."""
    from yet_another_wizz_tpu_torch.catalog import Catalog
    from yet_another_wizz_tpu_torch.config import Configuration
    from yet_another_wizz_tpu_torch.correlation.measurements import (
        autocorrelate,
        crosscorrelate,
    )
    from yet_another_wizz_tpu_torch.examples import generate_mock_data

    mock = generate_mock_data(
        num_reference=4000, num_unknown=6000, num_randoms=9000, seed=21
    )
    reference = Catalog.from_arrays(
        **mock["reference"], degrees=False, patch_num=12, device=device
    )
    centers = reference.get_centers()
    unknown, randoms = (
        Catalog.from_arrays(**mock[n], degrees=False, patch_centers=centers, device=device)
        for n in ("unknown", "randoms")
    )
    config = Configuration.create(
        rmin=500, rmax=3000, unit="kpc", zmin=0.15, zmax=1.0, num_bins=4
    )
    if shape == "cross":
        names = ("dd", "rd")

        def measure(**kwargs):
            return crosscorrelate(
                config, reference, unknown, ref_rand=randoms, device=device,
                **kwargs,
            )[0]
    else:
        names = ("dd", "dr", "rr")

        def measure(**kwargs):
            return autocorrelate(config, reference, randoms, device=device, **kwargs)[0]

    full = measure()
    tracing.reset()
    first, second = measure(max_resident_patches=4), measure(max_resident_patches=4)
    assert tracing.counters["blocked.upload_bytes"] > 0
    monkeypatch.setenv("YAWT_DEVICE_ACCUMULATE", "0")
    host_mode = measure(max_resident_patches=4)
    for name in names:
        counts = getattr(first, name).counts.counts
        expected = getattr(full, name).counts.counts
        np.testing.assert_allclose(counts, expected, rtol=1e-6, atol=1e-6 * np.abs(expected).max())
        np.testing.assert_array_equal(getattr(second, name).counts.counts, counts)
        np.testing.assert_allclose(
            getattr(host_mode, name).counts.counts, counts,
            rtol=1e-6, atol=1e-6 * np.abs(expected).max(),
        )


def test_flag_pass_on_the_card_equals_the_cpu(device):
    from yet_another_wizz_tpu_torch.coordinates import chord_to_angle
    from yet_another_wizz_tpu_torch.ops.paircount import (
        audit_band,
        boundary_flags,
        boundary_flags_torch,
    )

    tiles1, tiles2, pairs, table = cross_inputs(np.random.default_rng(11))
    edges = chord_to_angle(np.sqrt(table.astype(np.float64)))
    # a band wide enough that some tile pairs are flagged and some are not
    band = torch.from_numpy(audit_band(edges, table, rel_band=2e-3).astype(np.float32))
    index1 = torch.from_numpy(pairs.tile1[:256].astype(np.int64))
    index2 = torch.from_numpy(pairs.tile2[:256].astype(np.int64))
    args = (torch.from_numpy(table), band)
    on_cpu = boundary_flags(
        torch.from_numpy(tiles1.lane_data), torch.from_numpy(tiles2.lane_data),
        index1, index2, *args,
    )
    card_args = (
        tiles1.device_data(device), tiles2.device_data(device),
        index1.int().to(device), index2.int().to(device),
        *(a.to(device) for a in args),
    )
    tracing.reset()
    on_card = boundary_flags(*card_args)
    assert launched()["boundary_flags"] == 1
    plain = boundary_flags_torch(
        *card_args[:2], card_args[2].long(), card_args[3].long(), *card_args[4:]
    )
    assert 0 < int(on_cpu.sum()) < len(on_cpu)
    assert torch.equal(on_card.cpu(), on_cpu)
    assert torch.equal(on_card, plain)


def flag_inputs(case):
    """CPU inputs of a flag-pass comparison: ``(lanes1, lanes2, tile1,
    tile2, table, band)`` and ``cols_binned``."""
    import torch_audit_cases as cases
    from yet_another_wizz_tpu_torch.coordinates import chord_to_angle
    from yet_another_wizz_tpu_torch.ops.paircount import audit_band

    if case.startswith("edge"):
        _, binned, where = case.split("-")
        lanes1, lanes2, tile1, tile2, table = edge_case_inputs(
            19, signed=binned == "binned"
        )
        table, band = band_inputs(table, beyond=where == "beyond")
        return (lanes1, lanes2, tile1, tile2, table, band), binned == "binned"
    if case == "on-edge pair":
        data = cases.on_edge_case(np.random.default_rng(12345), 1.0)
        tiles1, tiles2, pairs = cases.port_inputs(data)
        table = data["chord2"]
        band = audit_band(data["edges"], table)
    else:
        rng = np.random.default_rng(13)
        if case in ("cross", "cross, 19 edges"):
            tiles1, tiles2, pairs, table = cross_inputs(
                rng, num_edges=19 if "19" in case else 3
            )
        else:  # signed row weights, unbinned or binned columns
            tiles1, tiles2, pairs, table, _ = variant_inputs(
                rng, "cumulative", case == "signed, binned"
            )
        edges = chord_to_angle(np.sqrt(table.astype(np.float64)))
        band = audit_band(edges, table, rel_band=2e-3)
    inputs = (
        torch.from_numpy(tiles1.lane_data), torch.from_numpy(tiles2.lane_data),
        torch.from_numpy(pairs.tile1.astype(np.int32)),
        torch.from_numpy(pairs.tile2.astype(np.int32)),
        torch.from_numpy(table), torch.from_numpy(band.astype(np.float32)),
    )
    return inputs, tiles2.binned


@pytest.mark.parametrize("case", [
    "cross", "cross, 19 edges", "signed", "signed, binned", "on-edge pair",
    "edge-cross-at", "edge-cross-beyond", "edge-binned-at", "edge-binned-beyond",
])
def test_flag_kernel_equals_the_plain_version(device, case):
    """The flag kernel's flags are bit for bit the plain version's on the
    card, one launch per group of 16 edges."""
    from yet_another_wizz_tpu_torch.ops.paircount import (
        boundary_flags,
        boundary_flags_torch,
    )

    inputs, cols_binned = flag_inputs(case)
    on_cpu = inputs
    inputs = [t.to(device) for t in inputs]
    tracing.reset()
    kernel = boundary_flags(*inputs, cols_binned=cols_binned)
    again = boundary_flags(*inputs, cols_binned=cols_binned)
    launches = launched()
    plain = boundary_flags_torch(
        *inputs[:2], inputs[2].long(), inputs[3].long(), *inputs[4:],
        cols_binned=cols_binned,
    )
    torch.cuda.synchronize()
    # two launches per group of 16 edges of each kernel: reach, triage,
    # evaluation
    groups = -(-inputs[4].shape[1] // 16)
    for name in cuda_paircount.FLAG_KERNELS:
        assert launches[name] == 2 * groups, name
    assert torch.equal(kernel, plain)
    assert torch.equal(again, kernel)
    if case in ("edge-cross-at", "edge-binned-at", "on-edge pair"):
        assert plain.any()
    check_triage(on_cpu, inputs, cols_binned)


def check_triage(on_cpu, on_card, cols_binned):
    """The reach and the work list of the first group of 16 edges, from
    the kernel's first two launches, equal their plain mirrors on the
    CPU."""
    from yet_another_wizz_tpu_torch.ops.paircount import (
        chunk_reach,
        flag_work_items,
    )
    from yet_another_wizz_tpu_torch.ops.tiles import chunk_caps

    lanes1, lanes2, tile1, tile2, table, band = on_cpu
    group = slice(0, 16)
    reach = cuda_paircount.flag_reach_cuda(*on_card[:1], *on_card[4:])
    caps1 = chunk_caps(lanes1)
    assert torch.equal(
        reach.cpu(), chunk_reach(lanes1, caps1, table[:, group], band[:, group])
    )
    items, length = cuda_paircount.flag_triage_cuda(
        *on_card[:4], reach, cols_binned=cols_binned
    )
    expected = flag_work_items(
        lanes1, caps1, chunk_caps(lanes2), tile1, tile2, table[:, group],
        band[:, group], cols_binned=cols_binned,
    )
    assert torch.equal(cuda_paircount.decode_work_items(items, length), expected)


def test_flag_kernel_over_edge_groups_and_extremes(device):
    """More than 16 edges whose first group flags tile pairs that the
    second would flag too (the later triage drops them); a band that flags
    every tile pair with a valid pair, and none that flags nothing: the
    flags are the plain version's."""
    from yet_another_wizz_tpu_torch.ops.paircount import (
        boundary_flags,
        boundary_flags_torch,
        flag_work_items,
    )
    from yet_another_wizz_tpu_torch.ops.tiles import chunk_caps

    (lanes1, lanes2, tile1, tile2, table, band), _ = flag_inputs("cross")
    # 20 edges: the table's three edges, repeated
    wide = table.repeat(1, 7)[:, :20].contiguous()
    wide_band = band.repeat(1, 7)[:, :20].contiguous()
    cases = {
        "20 edges": (wide, wide_band),
        "every pair near": (table, torch.full_like(band, 10.0)),
        # a negative half-width: no pair is near, and no chunk reaches
        "nothing near": (table, torch.full_like(band, -1.0)),
    }
    for name, (t, b) in cases.items():
        args = [x.to(device) for x in (lanes1, lanes2, tile1, tile2, t, b)]
        flags = boundary_flags(*args)
        plain = boundary_flags_torch(
            *args[:2], args[2].long(), args[3].long(), *args[4:]
        )
        torch.cuda.synchronize()
        assert torch.equal(flags, plain), name
        if name == "every pair near":
            assert plain.all()
        if name == "nothing near":
            assert not plain.any()
    # the second group's triage leaves out what the first group flagged
    first = boundary_flags_torch(
        lanes1, lanes2, tile1.long(), tile2.long(), wide[:, :16],
        wide_band[:, :16],
    )
    assert first.any()
    args = [x.to(device) for x in (lanes1, lanes2, tile1, tile2)]
    reach = cuda_paircount.flag_reach_cuda(
        args[0], wide.to(device), wide_band.to(device), edge0=16
    )
    items, length = cuda_paircount.flag_triage_cuda(
        *args, reach, flags=first.to(device), edge0=16
    )
    later = cuda_paircount.decode_work_items(items, length)
    expected = flag_work_items(
        lanes1, chunk_caps(lanes1), chunk_caps(lanes2), tile1, tile2,
        wide[:, 16:], wide_band[:, 16:], flags=first,
    )
    assert torch.equal(later, expected)
    assert not first[later[:, 0]].any()


def test_streamed_flag_pass_on_the_card(device, monkeypatch):
    """Beyond AUDIT_RESIDENT_BYTES the flag pass streams windows of
    host-gathered lanes through the kernel (one launch per window, the
    plain version never on the card): the flagged slots are the resident
    pass's and the CPU's."""
    import torch_audit_cases as cases
    from yet_another_wizz_tpu_torch.ops import paircount

    case = cases.on_edge_case(np.random.default_rng(12345), 1.0 + 1e-8)
    ts1, ts2, pairs = cases.port_inputs(case)

    def flagged(on):
        paircount.reset_audit_stats()
        count_pairs_tiles(
            ts1, ts2, pairs, case["chord2"], device=on,
            edges_radian=case["edges"], audit=True,
        )
        return paircount.AUDIT_STATS[-1]["flagged_slots"]

    resident, on_cpu = flagged(device), flagged("cpu")
    plain = paircount.boundary_flags_torch

    def cpu_only(lanes1, *args, **kwargs):
        assert lanes1.device.type == "cpu", "the plain flag pass ran on the card"
        return plain(lanes1, *args, **kwargs)

    monkeypatch.setattr(paircount, "boundary_flags_torch", cpu_only)
    monkeypatch.setattr(paircount, "AUDIT_RESIDENT_BYTES", 0)
    # windows of 64 tile pairs (the smallest window)
    monkeypatch.setattr(paircount, "AUDIT_WINDOW_BYTES", 1)
    tracing.reset()
    streamed = flagged(device)
    assert launched()["boundary_flags"] == -(-pairs.num_pairs // 64)
    assert pairs.num_pairs > 64
    assert len(resident) >= 1
    np.testing.assert_array_equal(streamed, resident)
    np.testing.assert_array_equal(resident, on_cpu)


def test_audit_repairs_the_flip_on_the_card(device):
    import torch_audit_cases as cases
    from yet_another_wizz_tpu_torch.ops.cpu_oracle import count_pairs_oracle

    case = cases.on_edge_case(np.random.default_rng(12345), 1.0)
    ts1, ts2, pairs = cases.port_inputs(case)
    expect = count_pairs_oracle(*cases.oracle_inputs(case, pairs))
    raw = count_pairs_tiles(ts1, ts2, pairs, case["chord2"], device=device)
    tracing.reset()
    fixed = count_pairs_tiles(
        ts1, ts2, pairs, case["chord2"], device=device,
        edges_radian=case["edges"], audit=True,
    )
    assert launched()["boundary_flags"] > 0
    assert np.abs(raw - expect).max() > 100.0  # the whole 1e4 pair weight
    assert np.abs(fixed - expect).max() < 1e-3


def test_blocked_audit_matches_in_memory_on_the_card(device):
    from yet_another_wizz_tpu_torch.catalog import Catalog
    from yet_another_wizz_tpu_torch.config import Configuration
    from yet_another_wizz_tpu_torch.correlation.measurements import autocorrelate
    from yet_another_wizz_tpu_torch.examples import generate_mock_data

    mock = generate_mock_data(
        num_reference=4000, num_unknown=10, num_randoms=9000, seed=21
    )
    reference = Catalog.from_arrays(
        **mock["reference"], degrees=False, patch_num=12, device=device
    )
    randoms = Catalog.from_arrays(
        **mock["randoms"], degrees=False,
        patch_centers=reference.get_centers(), device=device,
    )
    config = Configuration.create(
        rmin=500, rmax=3000, unit="kpc", zmin=0.15, zmax=1.0, num_bins=4
    )
    (memory,) = autocorrelate(config, reference, randoms, device=device, audit=True)
    tracing.reset()
    (blocked,) = autocorrelate(
        config, reference, randoms, device=device, audit=True,
        max_resident_patches=5,
    )
    assert launched()["boundary_flags"] > 0
    for name in ("dd", "dr", "rr"):
        np.testing.assert_allclose(
            getattr(blocked, name).counts.counts,
            getattr(memory, name).counts.counts, rtol=1e-6, atol=1e-6,
        )


@pytest.mark.parametrize("data_sharding", ["replicated", "columns", "ring"])
def test_sharded_on_repeated_card_matches_single_device(device, data_sharding):
    """Four shards on one card: the counts of each layout equal the
    single-device counts within 1e-6, and each shard launches kernel A and
    kernel B once per non-empty step."""
    from yet_another_wizz_tpu_torch.parallel import Mesh, count_pairs_sharded

    rng = np.random.default_rng(11)
    tiles1, tiles2, pairs, table = cross_inputs(rng)
    single = count_pairs_tiles(
        tiles1, tiles2, pairs, table, device=device, mesh="single"
    )
    mesh = Mesh([torch.device("cuda", 0)] * 4)
    tracing.reset()
    sharded = count_pairs_sharded(
        tiles1, tiles2, pairs, table, mesh=mesh, data_sharding=data_sharding
    )
    launches = launched()
    steps = sum(len(shard) for shard in pairs._device_cache[("shards", data_sharding, 4)])
    assert launches["paircount_partials"] == steps
    assert launches["paircount_segment_sum"] == steps
    np.testing.assert_allclose(
        sharded, single, rtol=1e-6, atol=1e-6 * np.abs(single).max()
    )


def test_parquet_ingestion_in_two_rounds_on_the_card(device, tmp_path, monkeypatch):
    """A chunked Parquet file streamed into a cache in two reader rounds,
    with the patch assignment on the card (its row threshold set to 0),
    equals the single-round ingestion bit for bit, patch by patch, and the
    card holds no more memory after the second round than after the first."""
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    from yet_another_wizz_tpu_torch.catalog import Catalog, ingest
    from yet_another_wizz_tpu_torch.examples import generate_mock_data
    from yet_another_wizz_tpu_torch.ops import kmeans

    mock = generate_mock_data(num_reference=20_000, num_unknown=1, num_randoms=1, seed=5)
    sample = mock["reference"]
    path = tmp_path / "sample.pqt"
    with pq.ParquetWriter(path, pa.schema([(k, pa.float64()) for k in ("ra", "dec", "z", "w")])) as writer:
        for start in range(0, 20_000, 5_000):  # four row groups
            part = slice(start, start + 5_000)
            writer.write_table(pa.table(dict(
                ra=np.rad2deg(sample["ra"][part]), dec=np.rad2deg(sample["dec"][part]),
                z=sample["redshifts"][part], w=sample["weights"][part],
            )))
    centers = Catalog.from_arrays(
        sample["ra"], sample["dec"], degrees=False, patch_num=16, device=device
    ).get_centers()
    monkeypatch.setattr(kmeans, "DEVICE_ASSIGN_THRESHOLD", 0)
    rounds, held = [], []
    original = ingest._chunk_patch_ids

    def counted(chunk, centers_xyz, chunk_device):
        out = original(chunk, centers_xyz, chunk_device)
        torch.cuda.synchronize()
        rounds.append(len(chunk))
        held.append(torch.cuda.memory_allocated())
        return out

    monkeypatch.setattr(ingest, "_chunk_patch_ids", counted)
    columns = dict(ra_name="ra", dec_name="dec", redshift_name="z", weight_name="w")
    for name, chunksize in (("two", 10_000), ("one", None)):
        Catalog.from_file(tmp_path / name, path, patch_centers=centers, streaming=True,
                          chunksize=chunksize, device=device, **columns)
    assert rounds == [10_000, 10_000, 20_000]
    assert held[1] <= held[0]
    for pid in range(16):
        for file in ("data.bin", "meta.yml"):
            two = (tmp_path / "two" / f"patch_{pid}" / file).read_bytes()
            one = (tmp_path / "one" / f"patch_{pid}" / file).read_bytes()
            assert two == one, (pid, file)


def test_measurement_after_build_trees_uploads_and_builds_nothing(device, monkeypatch):
    """After ``build_trees`` on the card, a crosscorrelation builds no tile
    set, uploads no lanes and derives no chunk caps, and its counts equal,
    bit for bit, those of catalogs that built and uploaded on demand."""
    from yet_another_wizz_tpu_torch.catalog import Catalog
    from yet_another_wizz_tpu_torch.catalog import catalog as catalog_module
    from yet_another_wizz_tpu_torch.config import Configuration
    from yet_another_wizz_tpu_torch.correlation.measurements import (
        PatchLinkage,
        crosscorrelate,
    )
    from yet_another_wizz_tpu_torch.examples import generate_mock_data
    from yet_another_wizz_tpu_torch.ops import tiles

    mock = generate_mock_data(
        num_reference=4000, num_unknown=6000, num_randoms=9000, seed=21
    )
    centers = Catalog.from_arrays(
        **mock["reference"], degrees=False, patch_num=12, device=device
    ).get_centers()

    def catalogs():
        return [
            Catalog.from_arrays(**mock[n], degrees=False, patch_centers=centers, device=device)
            for n in ("reference", "unknown", "randoms")
        ]

    config = Configuration.create(
        rmin=500, rmax=3000, unit="kpc", zmin=0.15, zmax=1.0, num_bins=4
    )
    reference, unknown, randoms = catalogs()
    (expected,) = crosscorrelate(config, reference, unknown, ref_rand=randoms, device=device)

    reference, unknown, randoms = catalogs()
    max_angle = PatchLinkage.from_catalogs(config, reference, unknown, randoms).edges.max_angle
    for catalog in (reference, randoms):
        catalog.build_trees(config.binning.binning.edges, max_angle=max_angle, device=device)
    unknown.build_trees(None, device=device)
    events = []

    def spy(module, name):
        original = getattr(module, name)

        def counted(*args, **kwargs):
            events.append(name)
            return original(*args, **kwargs)

        monkeypatch.setattr(module, name, counted)

    spy(catalog_module, "build_tile_set")
    spy(tiles, "_Upload")
    spy(cuda_paircount, "chunk_caps")
    tracing.reset()
    (warmed,) = crosscorrelate(config, reference, unknown, ref_rand=randoms, device=device)
    assert events == []
    assert launched()["paircount_partials"] == 2
    for name in ("dd", "rd"):
        np.testing.assert_array_equal(
            getattr(warmed, name).counts.counts, getattr(expected, name).counts.counts
        )
