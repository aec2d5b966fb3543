"""The port's exact-boundary audit against the JAX package's.

The audit flags every tile pair holding a valid pair within float32
resolution of a threshold of its row's bin, and recounts the slots of the
flagged tile pairs with the float64 oracle (``audit_boundary_counts`` in
both packages). Held here, with float lanes on both sides:

- the engineered on-edge pair of the JAX package's ``tests/test_engine.py``
  (``TestBoundaryAudit``; ``torch_audit_cases.py``): audited counts match
  the oracle at ``rtol=1e-5, atol=1e-2`` (that test's tolerances), and the
  genuine flip, the whole 1e4 pair weight on the wrong side of the edge,
  is repaired. The port flips at ``nudge = 1`` where the JAX package's XLA
  engine flips at ``1 + 1e-8``: the jitted XLA chord of that pair is one
  float32 ulp below the port's, which equals the CUDA kernels' and JAX's
  own unjitted operations;
- the flag pass: per tile pair equal to JAX's ``_boundary_flags_xla`` on
  the same tiles, the streamed (gathered) pass equal to the resident one,
  and the flagged slots equal to those JAX recounts;
- the band: without JAX's fixed-point term (zero for float lanes) it is
  JAX's band;
- the measurements: audited ``crosscorrelate``, blocked ``autocorrelate``
  against the in-memory one, the scalar measurements, and direct-mode
  configurations, which the audit counts with the union edges.
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import torch_audit_cases as cases
from yet_another_wizz_tpu.catalog import Catalog as JaxCatalog
from yet_another_wizz_tpu.config import Configuration as JaxConfiguration
from yet_another_wizz_tpu.correlation import measurements as jax_measurements
from yet_another_wizz_tpu.ops import cpu_oracle as jax_cpu_oracle
from yet_another_wizz_tpu.ops import paircount as jax_paircount
from yet_another_wizz_tpu.ops.linkage import build_linkage as jax_build_linkage
from yet_another_wizz_tpu.ops.linkage import build_tile_pairs as jax_build_tile_pairs
from yet_another_wizz_tpu.ops.tiles import build_tile_set as jax_build_tile_set
from yet_another_wizz_tpu_torch import interop
from yet_another_wizz_tpu_torch.catalog import Catalog
from yet_another_wizz_tpu_torch.config import Configuration
from yet_another_wizz_tpu_torch.correlation import measurements
from yet_another_wizz_tpu_torch.examples import generate_mock_data
from yet_another_wizz_tpu_torch.ops import paircount
from yet_another_wizz_tpu_torch.ops.cpu_oracle import count_pairs_oracle
from yet_another_wizz_tpu_torch.ops.paircount import (
    AUDIT_STATS,
    audit_band,
    boundary_flags,
    count_pairs_tiles,
    pair_block_boundary,
    reset_audit_stats,
)

RTOL, ATOL = 1e-5, 1e-2
"""Audited counts against the float64 oracle (``tests/test_engine.py``)."""
FLIP_NUDGE = 1.0
"""The nudge at which the port's float32 engine puts the heavy pair of
``torch_audit_cases`` (rng 12345) on the wrong side of the edge."""
SIZES = dict(num_reference=3000, num_unknown=4000, num_randoms=6000)
CONFIG = dict(rmin=500, rmax=3000, unit="kpc", zmin=0.15, zmax=1.0, num_bins=4)
CONFIG_DIRECT = dict(
    rmin=[100, 300, 500], rmax=[300, 500, 1000], unit="kpc", rweight=-1.0,
    resolution=32, zmin=0.15, zmax=1.0, num_bins=4,
)


@pytest.fixture(autouse=True)
def float_lanes(monkeypatch):
    """The JAX engines upload float lanes, like the port."""
    monkeypatch.setenv("YAWT_LANE_ENCODING", "float")


def jax_inputs(case):
    """The JAX package's tile sets and pair list of an engineered case."""
    ts1 = jax_build_tile_set(
        case["xyz1"], case["patch1"], cases.NUM_PATCHES, weights=case["w1"],
        zbins=case["z1"], num_bins=cases.NUM_BINS, tile_size=cases.TILE_SIZE,
    )
    ts2 = jax_build_tile_set(
        case["xyz2"], case["patch2"], cases.NUM_PATCHES, weights=case["w2"],
        tile_size=cases.TILE_SIZE,
    )
    centers, radii = cases.patch_geometry(
        case["xyz1"], case["patch1"], cases.NUM_PATCHES
    )
    linkage = jax_build_linkage(centers, radii, case["edges"].max() * 1.000001)
    return ts1, ts2, jax_build_tile_pairs(ts1, ts2, linkage, auto=False)


def measure(nudge, *, audit, seed=12345):
    """The port's counts of an engineered case, the oracle's, and the
    flagged slots of the audit (None without it)."""
    case = cases.on_edge_case(np.random.default_rng(seed), nudge)
    ts1, ts2, pairs = cases.port_inputs(case)
    reset_audit_stats()
    result = count_pairs_tiles(
        ts1, ts2, pairs, case["chord2"], device="cpu",
        edges_radian=case["edges"], audit=audit,
    )
    expect = count_pairs_oracle(*cases.oracle_inputs(case, pairs))
    flagged = AUDIT_STATS[-1]["flagged_slots"] if audit else None
    return result, expect, flagged


@pytest.mark.parametrize("nudge", [1.0, 1.0 + 1e-8, 1.0 + 5e-8, 1.0 - 5e-8])
def test_on_edge_pair_matches_oracle(nudge):
    result, expect, flagged = measure(nudge, audit=True)
    assert len(flagged) >= 1
    assert_allclose(result, expect, rtol=RTOL, atol=ATOL)
    # the JAX package's audited counts of the same points
    case = cases.on_edge_case(np.random.default_rng(12345), nudge)
    ts1, ts2, pairs = jax_inputs(case)
    theirs = jax_paircount.count_pairs_tiles(
        ts1, ts2, pairs, case["chord2"], backend="xla", mesh="single",
        edges_radian=case["edges"], audit=True,
    )
    assert_allclose(result, theirs, rtol=RTOL, atol=ATOL)


def test_genuine_flip_repaired():
    raw, expect, _ = measure(FLIP_NUDGE, audit=False)
    fixed, expect, flagged = measure(FLIP_NUDGE, audit=True)
    assert np.abs(raw - expect).max() > 100.0  # the whole pair misplaced
    assert len(flagged) >= 1
    assert np.abs(fixed - expect).max() < 1e-3
    # the flagged slots hold the float64 oracle's counts of the tiles' own
    # points (the oracle backend's), the others the engine's unchanged
    case = cases.on_edge_case(np.random.default_rng(12345), FLIP_NUDGE)
    ts1, ts2, pairs = cases.port_inputs(case)
    backend = count_pairs_tiles(
        ts1, ts2, pairs, case["chord2"], backend="oracle",
        edges_radian=case["edges"],
    )
    assert_array_equal(fixed[flagged], backend[flagged])
    unflagged = np.setdiff1d(np.arange(len(raw)), flagged)
    assert_array_equal(fixed[unflagged], raw[unflagged])


def test_far_from_edges_passes_through():
    raw, expect, _ = measure(0.5, audit=False)
    result, expect, flagged = measure(0.5, audit=True)
    assert_allclose(result, expect, rtol=1e-4, atol=0.5)
    unflagged = np.setdiff1d(np.arange(len(raw)), flagged)
    assert len(unflagged) > 0
    assert_array_equal(result[unflagged], raw[unflagged])


def test_threaded_recount_is_bitwise_the_single_thread_one(monkeypatch):
    """With the measurement's ``max_workers`` the recount runs on threads,
    each slot counted whole by one of them: the same bits as one thread."""
    from yet_another_wizz_tpu_torch.utils.misc import thread_limit

    band = paircount.audit_band
    monkeypatch.setattr(  # flag every slot
        paircount, "audit_band", lambda e, t, rel_band=1e-6: band(e, t, 1.0)
    )
    single, expect, flagged = measure(1.0, audit=True)
    assert AUDIT_STATS[-1]["recount_workers"] == 1 and len(flagged) > 4
    with thread_limit(4):
        threaded, _, _ = measure(1.0, audit=True)
    assert AUDIT_STATS[-1]["recount_workers"] == 4
    assert_array_equal(threaded, single)
    assert_allclose(single, expect, rtol=RTOL, atol=ATOL)


def test_audit_requires_edges():
    with pytest.raises(ValueError, match="edges_radian"):
        count_pairs_tiles(
            None, None, None, np.zeros((1, 2), np.float32), audit=True
        )


def test_gathered_flag_pass_matches_resident(monkeypatch):
    """Tile sets beyond AUDIT_RESIDENT_BYTES stream windows of
    host-gathered lanes through the flag pass; flags and repaired counts
    equal the resident pass's."""
    resident, expect, flagged_resident = measure(1.0 + 1e-8, audit=True)
    monkeypatch.setattr(paircount, "AUDIT_RESIDENT_BYTES", 1)
    # windows of 16 tile pairs: several windows over the list
    monkeypatch.setattr(paircount, "AUDIT_WINDOW_BYTES", 16 * 2 * 8 * 64 * 4)
    gathered, _, flagged_gathered = measure(1.0 + 1e-8, audit=True)
    assert len(flagged_resident) >= 1
    assert_array_equal(flagged_gathered, flagged_resident)
    assert_array_equal(gathered, resident)
    assert_allclose(gathered, expect, rtol=RTOL, atol=ATOL)


def random_tiles(seed, cols_binned):
    """The JAX package's tiles of two random catalogs (binned rows; binned
    or unbinned columns), per-bin edges, the pair list, and the same tiles
    and list in the port."""
    rng = np.random.default_rng(seed)
    num_bins, num_patches = 3, 5
    xyz1, w1, z1 = cases.random_cap_catalog(rng, 2500, num_bins, cap_deg=8.0)
    xyz2, w2, z2 = cases.random_cap_catalog(rng, 3000, num_bins, cap_deg=8.0)
    pick = np.random.default_rng(3).choice(len(xyz1), num_patches, replace=False)
    centers = xyz1[pick]
    patch1 = np.argmax(xyz1 @ centers.T, axis=1)
    patch2 = np.argmax(xyz2 @ centers.T, axis=1)
    ts1 = jax_build_tile_set(
        xyz1, patch1, num_patches, weights=w1, zbins=z1, num_bins=num_bins,
        tile_size=64,
    )
    ts2 = jax_build_tile_set(
        xyz2, patch2, num_patches, weights=w2,
        zbins=z2 if cols_binned else None, num_bins=num_bins if cols_binned else 0,
        tile_size=64,
    )
    edges = np.deg2rad(np.tile((0.2, 0.5, 1.0), (num_bins, 1)))
    edges *= np.linspace(1.0, 0.6, num_bins)[:, None]
    chord2 = ((2 * np.sin(edges / 2)) ** 2).astype(np.float32)
    pcenters, pradii = cases.patch_geometry(xyz1, patch1, num_patches)
    linkage = jax_build_linkage(pcenters, pradii, edges.max() * 1.000001)
    pairs = jax_build_tile_pairs(ts1, ts2, linkage, auto=False)
    fields = (
        "lane_data", "tile_patch", "tile_center", "tile_radius",
        "patch_tile_start", "patch_tile_stop", "sum_weights", "tile_zmin",
        "tile_zmax", "num_bins", "num_points",
    )
    port = [
        interop.tileset_from_arrays(**{name: getattr(ts, name) for name in fields})
        for ts in (ts1, ts2)
    ]
    port_pairs = interop.tilepairs_from_arrays(
        pairs.tile1, pairs.tile2, pairs.slot, pairs.slot_patches
    )
    return dict(
        jax=(ts1, ts2, pairs), port=(*port, port_pairs), edges=edges,
        chord2=chord2,
    )


@pytest.mark.parametrize("cols_binned", [False, True], ids=["cross", "auto"])
def test_flags_equal_jax(cols_binned):
    """Per tile pair, the port's flag pass equals the JAX package's on the
    same tiles, with a band wide enough that some tile pairs are flagged
    and some are not."""
    data = random_tiles(7, cols_binned)
    ts1, ts2, pairs = data["jax"]
    band = audit_band(data["edges"], data["chord2"], rel_band=2e-3)
    chunk = 16
    padded = -(-pairs.num_pairs // chunk) * chunk
    tile1 = np.full(padded, pairs.tile1[0], np.int32)
    tile2 = np.full(padded, pairs.tile2[0], np.int32)
    tile1[: pairs.num_pairs], tile2[: pairs.num_pairs] = pairs.tile1, pairs.tile2
    theirs = np.asarray(jax_paircount._boundary_flags_xla(
        ts1.lane_data, ts2.lane_data, tile1, tile2, data["chord2"],
        band.astype(np.float32), cols_binned=cols_binned, chunk_size=chunk,
    ))[: pairs.num_pairs]
    ours = boundary_flags(
        torch.from_numpy(ts1.lane_data), torch.from_numpy(ts2.lane_data),
        torch.from_numpy(pairs.tile1.astype(np.int64)),
        torch.from_numpy(pairs.tile2.astype(np.int64)),
        torch.from_numpy(data["chord2"]), torch.from_numpy(band.astype(np.float32)),
        cols_binned=cols_binned,
    ).numpy()
    assert 0 < ours.sum() < len(ours)
    assert_array_equal(ours, theirs)


def captured_jax_audit(monkeypatch, ts1, ts2, pairs, counts, chord2, edges):
    """JAX ``audit_boundary_counts`` with the band table its flag pass gets
    and the slot patches its oracle recounts."""
    seen = {}
    flags_xla = jax_paircount._boundary_flags_xla
    oracle = jax_cpu_oracle.count_pairs_oracle

    def flags_spy(*args, **kwargs):
        seen["band"] = np.asarray(args[5])
        return flags_xla(*args, **kwargs)

    def oracle_spy(*args, **kwargs):
        seen["slot_patches"] = np.asarray(args[8])
        return oracle(*args, **kwargs)

    monkeypatch.setattr(jax_paircount, "_boundary_flags_xla", flags_spy)
    monkeypatch.setattr(jax_cpu_oracle, "count_pairs_oracle", oracle_spy)
    try:
        result = jax_paircount.audit_boundary_counts(
            ts1, ts2, pairs, counts, chord2, edges
        )
    finally:
        monkeypatch.undo()
    return result, seen


@pytest.mark.parametrize("nudge", [1.0, 1.0 + 1e-8, 0.5])
def test_flagged_slots_equal_jax(monkeypatch, nudge):
    """``audit_boundary_counts`` of both packages on the same tiles and
    counts: the same slots are recounted and give the same counts."""
    case = cases.on_edge_case(np.random.default_rng(12345), nudge)
    ts1, ts2, pairs = jax_inputs(case)
    counts = jax_paircount.count_pairs_tiles(
        ts1, ts2, pairs, case["chord2"], backend="xla", mesh="single"
    )
    (theirs, num_theirs), seen = captured_jax_audit(
        monkeypatch, ts1, ts2, pairs, counts, case["chord2"], case["edges"]
    )
    port_ts1, port_ts2, port_pairs = cases.port_inputs(case)
    reset_audit_stats()
    ours, num_ours = paircount.audit_boundary_counts(
        port_ts1, port_ts2, port_pairs, counts, case["chord2"], case["edges"],
        device="cpu",
    )
    assert num_ours == num_theirs
    flagged = AUDIT_STATS[-1]["flagged_slots"]
    assert_array_equal(port_pairs.slot_patches, pairs.slot_patches)
    if num_theirs:
        assert_array_equal(pairs.slot_patches[flagged], seen["slot_patches"])
    assert_array_equal(ours, theirs)


def test_band_equals_jax_without_the_fixed_point_term(monkeypatch):
    """JAX's band on float lanes (its fixed-point term is zero) is the
    port's; on fixed-point lanes JAX widens it, which the port's float32
    lanes never need."""
    case = cases.on_edge_case(np.random.default_rng(12345), 1.0)
    ts1, ts2, pairs = jax_inputs(case)
    counts = np.zeros((pairs.num_slots, cases.NUM_BINS, 2))
    _, seen = captured_jax_audit(
        monkeypatch, ts1, ts2, pairs, counts, case["chord2"], case["edges"]
    )
    band = audit_band(case["edges"], case["chord2"])
    assert_array_equal(seen["band"], band.astype(np.float32))
    monkeypatch.setenv("YAWT_LANE_ENCODING", "fixedpoint")
    _, seen = captured_jax_audit(
        monkeypatch, ts1, ts2, pairs, counts, case["chord2"], case["edges"]
    )
    assert np.all(seen["band"] > band.astype(np.float32))


def test_validity_counts_negative_weights_and_drops_padding():
    """A pair on an edge is flagged when its weights are nonzero, negative
    ones included, and never when a weight is zero (padding) or, with
    binned columns, when the bins differ."""
    lanes1 = torch.zeros((1, 8, 32))
    lanes2 = torch.zeros((1, 8, 32))
    lanes1[0, 0, 0], lanes2[0, 0, 0] = 1.0, 0.875
    # the pair's squared chord (0.125^2, exact in float32) is the first
    # threshold; every other pair of the tiles has weight 0
    chord2_table = torch.tensor([[0.125**2, 0.5]])
    band = torch.tensor([[1e-8, 1e-8]])
    signed = ((1.0, -2.0, True), (-1.0, 1.0, True), (0.0, 1.0, False))
    for w1, w2, expected in (*signed, (1.0, 0.0, False)):
        lanes1[0, 6, 0], lanes2[0, 6, 0] = w1, w2
        flag = pair_block_boundary(lanes1, lanes2, chord2_table, band)
        assert bool(flag[0]) is expected
    lanes1[0, 6, 0], lanes2[0, 6, 0] = 1.0, 1.0
    lanes2[0, 7, 0] = 1.0  # another bin
    assert bool(pair_block_boundary(lanes1, lanes2, chord2_table, band)[0])
    assert not bool(
        pair_block_boundary(lanes1, lanes2, chord2_table, band, cols_binned=True)[0]
    )


def make_catalogs(catalog_cls, mock, **kwargs):
    rng = np.random.default_rng(5)
    ref = dict(mock["reference"])
    ref["kappa"] = rng.normal(0.1, 0.3, len(ref["ra"]))
    reference = catalog_cls.from_arrays(**ref, degrees=False, patch_num=5, **kwargs)
    centers = reference.get_centers()
    unknown = catalog_cls.from_arrays(
        **mock["unknown"], degrees=False, patch_centers=centers, **kwargs
    )
    randoms = catalog_cls.from_arrays(
        **mock["randoms"], degrees=False, patch_centers=centers, **kwargs
    )
    return reference, unknown, randoms


@pytest.fixture(scope="module")
def packages():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("YAWT_LANE_ENCODING", "float")
        mock = generate_mock_data(**SIZES, seed=9)
        return dict(
            port=make_catalogs(Catalog, mock, device="cpu"),
            jax=make_catalogs(JaxCatalog, mock),
        )


def assert_counts_close(actual, desired, rtol=1e-6):
    desired = np.asarray(desired)
    assert_allclose(actual, desired, rtol=rtol, atol=rtol * np.abs(desired).max())


def test_audited_crosscorrelate_through_the_public_api(packages):
    reference, unknown, randoms = packages["port"]
    config = Configuration.create(**CONFIG)
    reset_audit_stats()
    (audited,) = measurements.crosscorrelate(
        config, reference, unknown, ref_rand=randoms, device="cpu", audit=True
    )
    assert len(AUDIT_STATS) == 2  # DD and RD
    (plain,) = measurements.crosscorrelate(
        config, reference, unknown, ref_rand=randoms, device="cpu"
    )
    (theirs,) = jax_measurements.crosscorrelate(
        JaxConfiguration.create(**CONFIG), *packages["jax"][:2],
        ref_rand=packages["jax"][2], backend="xla", mesh="single", audit=True,
    )
    for name in ("dd", "rd"):
        ours = getattr(audited, name).counts.counts
        assert_allclose(ours, getattr(plain, name).counts.counts, rtol=RTOL, atol=ATOL)
        assert_counts_close(ours, getattr(theirs, name).counts.counts)
    assert_allclose(audited.sample().data, theirs.sample().data, rtol=1e-5)


def test_blocked_audit_equals_in_memory(packages):
    reference, _, randoms = packages["port"]
    config = Configuration.create(**CONFIG)
    (memory,) = measurements.autocorrelate(
        config, reference, randoms, device="cpu", audit=True
    )
    (blocked,) = measurements.autocorrelate(
        config, reference, randoms, device="cpu", audit=True,
        max_resident_patches=2,
    )
    for name in ("dd", "dr", "rr"):
        assert_allclose(
            getattr(blocked, name).counts.counts,
            getattr(memory, name).counts.counts, rtol=1e-6, atol=1e-6,
        )
    assert_allclose(blocked.sample().data, memory.sample().data, rtol=1e-5)


def test_blocked_audit_keeps_the_float64_recount(packages, monkeypatch):
    """With a band that flags every slot, every count is the oracle's: the
    blocked path scatters the recounted float64 values on the host (a
    float32 device accumulation would round them), so it equals the
    in-memory path and the oracle backend bit for bit."""
    band = paircount.audit_band
    monkeypatch.setattr(
        paircount, "audit_band", lambda e, t, rel_band=1e-6: band(e, t, 1.0)
    )
    reference, unknown, _ = packages["port"]
    config = Configuration.create(**CONFIG)
    run = dict(device="cpu")
    (memory,) = measurements.crosscorrelate(
        config, reference, unknown, unk_rand=packages["port"][2], audit=True,
        **run,
    )
    (blocked,) = measurements.crosscorrelate(
        config, reference, unknown, unk_rand=packages["port"][2], audit=True,
        max_resident_patches=2, **run,
    )
    links = measurements.PatchLinkage.from_catalogs(config, reference, unknown)
    (oracle,) = links.count_pairs(reference, unknown, backend="oracle")
    assert_array_equal(blocked.dd.counts.counts, memory.dd.counts.counts)
    assert_array_equal(memory.dd.counts.counts, oracle.counts.counts)
    assert_array_equal(blocked.dr.counts.counts, memory.dr.counts.counts)


def test_scalar_audit_with_negative_weights(packages):
    reference, unknown, randoms = packages["port"]
    jax_reference, jax_unknown, jax_randoms = packages["jax"]
    assert np.any(reference.kappa < 0)
    config = Configuration.create(**CONFIG)
    jax_config = JaxConfiguration.create(**CONFIG)
    jax_run = dict(backend="xla", mesh="single", audit=True)
    (cross,) = measurements.crosscorrelate_scalar(
        config, reference, unknown, unk_rand=randoms, device="cpu", audit=True
    )
    (auto,) = measurements.autocorrelate_scalar(
        config, reference, device="cpu", audit=True, max_resident_patches=2
    )
    (jax_cross,) = jax_measurements.crosscorrelate_scalar(
        jax_config, jax_reference, jax_unknown, unk_rand=jax_randoms, **jax_run
    )
    (jax_auto,) = jax_measurements.autocorrelate_scalar(
        jax_config, jax_reference, **jax_run
    )
    for ours, theirs, names in (
        (cross, jax_cross, ("dd", "dr")), (auto, jax_auto, ("dd",))
    ):
        for name in names:
            for part in ("kappa_counts", "number_counts"):
                assert_counts_close(
                    getattr(getattr(ours, name), part).counts,
                    getattr(getattr(theirs, name), part).counts,
                )
        assert_allclose(
            ours.sample().data, theirs.sample().data, rtol=1e-4, atol=1e-7
        )


def test_direct_mode_audits_with_union_edges(packages):
    """``direct`` with audit is refused by the engine; the measurements
    then count with the union edges, as the JAX package's do."""
    reference, unknown, randoms = packages["port"]
    config = Configuration.create(**CONFIG_DIRECT)
    links = measurements.PatchLinkage.from_catalogs(config, reference, unknown)
    assert links.edges.direct is not None
    assert links.engine_table()[2] is not None
    assert links.engine_table(audit=True)[2] is None
    tiles1, tiles2, pairs = links._build_engine_inputs(reference, unknown)
    table, edges, spec, _ = links.engine_table()
    with pytest.raises(ValueError, match="cumulative"):
        count_pairs_tiles(
            tiles1, tiles2, pairs, table, device="cpu", edges_radian=edges,
            direct=spec, audit=True,
        )
    reset_audit_stats()
    ours = measurements.crosscorrelate(
        config, reference, unknown, ref_rand=randoms, device="cpu", audit=True
    )
    assert len(AUDIT_STATS) == 2
    theirs = jax_measurements.crosscorrelate(
        JaxConfiguration.create(**CONFIG_DIRECT), *packages["jax"][:2],
        ref_rand=packages["jax"][2], backend="xla", mesh="single", audit=True,
    )
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        for name in ("dd", "rd"):
            assert_counts_close(
                getattr(a, name).counts.counts, getattr(b, name).counts.counts
            )


def test_multi_device_options_still_raise(packages):
    """An audited run under a mesh repairs the sharded counts into those of
    the single-device audited run; a mesh that is not a ``Mesh`` raises."""
    from yet_another_wizz_tpu_torch.parallel import default_mesh

    reference, unknown, randoms = packages["port"]
    config = Configuration.create(**CONFIG)
    with pytest.raises(TypeError, match="Mesh"):
        measurements.crosscorrelate(
            config, reference, unknown, ref_rand=randoms, device="cpu",
            audit=True, mesh="columns",
        )
    (single,) = measurements.crosscorrelate(
        config, reference, unknown, ref_rand=randoms, device="cpu", audit=True,
        mesh="single",
    )
    (sharded,) = measurements.crosscorrelate(
        config, reference, unknown, ref_rand=randoms, device="cpu", audit=True,
        mesh=default_mesh(3, "cpu"), data_sharding="ring",
    )
    for name in ("dd", "rd"):
        assert_counts_close(
            getattr(sharded, name).counts.counts,
            getattr(single, name).counts.counts,
        )
