"""The PyTorch port's main path against the JAX package, end to end.

Both packages run the same measurement on the same mock arrays: mock data
-> ``Catalog.from_arrays`` with kmeans patches -> ``crosscorrelate`` (DD
and RD) -> ``RedshiftData.from_corrfuncs`` (jackknife). The host pipeline
is a copy, so patch ids, tile lanes and tile-pair lists must be EQUAL. The
pair counts differ only in the order of float32 sums (same chord
arithmetic), hence ``rtol=1e-6`` with ``atol=1e-6 * max|ref|``. The port
runs its plain PyTorch engine on the CPU (``device="cpu"``); the JAX
package its XLA engine on one device, with float lanes
(``YAWT_LANE_ENCODING=float``: its default fixed-point lanes move points
by up to sqrt(3)/2 of a quantisation step).
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import numpy as np
import pytest
from numpy.testing import assert_allclose, assert_array_equal

import yet_another_wizz_tpu_torch as port
from yet_another_wizz_tpu.catalog import Catalog as JaxCatalog
from yet_another_wizz_tpu.config import Configuration as JaxConfiguration
from yet_another_wizz_tpu.correlation.measurements import (
    PatchLinkage as JaxPatchLinkage,
    crosscorrelate as jax_crosscorrelate,
)
from yet_another_wizz_tpu.examples import generate_mock_data as jax_mock
from yet_another_wizz_tpu.ops.cpu_oracle import count_pairs_oracle
from yet_another_wizz_tpu.ops.paircount import _unpack_tileset
from yet_another_wizz_tpu.redshifts import RedshiftData as JaxRedshiftData
from yet_another_wizz_tpu_torch.catalog import Catalog
from yet_another_wizz_tpu_torch.config import Configuration
from yet_another_wizz_tpu_torch.correlation.measurements import (
    PatchLinkage,
    crosscorrelate,
)
from yet_another_wizz_tpu_torch.examples import generate_mock_data
from yet_another_wizz_tpu_torch.ops.paircount import count_pairs_tiles
from yet_another_wizz_tpu_torch.redshifts import RedshiftData

SIZES = dict(num_reference=3000, num_unknown=6000, num_randoms=12000)
SEED = 7
CONFIG = dict(
    rmin=100, rmax=1000, unit="kpc", zmin=0.15, zmax=1.0, num_bins=4
)
RTOL = 1e-6


def assert_counts_close(actual, desired):
    desired = np.asarray(desired)
    assert_allclose(
        actual, desired, rtol=RTOL, atol=RTOL * np.abs(desired).max()
    )


def make_catalogs(catalog_cls, mock):
    reference = catalog_cls.from_arrays(
        **mock["reference"], degrees=False, patch_num=8
    )
    centers = reference.get_centers()
    unknown = catalog_cls.from_arrays(
        **mock["unknown"], degrees=False, patch_centers=centers
    )
    randoms = catalog_cls.from_arrays(
        **mock["randoms"], degrees=False, patch_centers=centers
    )
    return reference, unknown, randoms


@pytest.fixture(scope="module")
def measured():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("YAWT_LANE_ENCODING", "float")
        mocks = (jax_mock(**SIZES, seed=SEED), generate_mock_data(**SIZES, seed=SEED))
        jax_cats = make_catalogs(JaxCatalog, mocks[0])
        port_cats = make_catalogs(Catalog, mocks[1])
        jax_config = JaxConfiguration.create(**CONFIG)
        config = Configuration.create(**CONFIG)
        (jax_wsp,) = jax_crosscorrelate(
            jax_config, *jax_cats[:2], ref_rand=jax_cats[2],
            backend="xla", mesh="single",
        )
        (wsp,) = crosscorrelate(
            config, *port_cats[:2], ref_rand=port_cats[2], device="cpu"
        )
        return dict(
            mocks=mocks,
            jax_cats=jax_cats,
            port_cats=port_cats,
            jax_links=JaxPatchLinkage.from_catalogs(jax_config, *jax_cats),
            links=PatchLinkage.from_catalogs(config, *port_cats),
            jax_wsp=jax_wsp,
            wsp=wsp,
        )


def test_mock_data_is_identical(measured):
    jax_mock_data, mock_data = measured["mocks"]
    for sample, columns in jax_mock_data.items():
        for name, values in columns.items():
            assert_array_equal(mock_data[sample][name], values)


@pytest.mark.parametrize("index", [0, 1, 2], ids=["ref", "unk", "rand"])
def test_patch_ids_are_identical(measured, index):
    jax_cat = measured["jax_cats"][index]
    cat = measured["port_cats"][index]
    assert_array_equal(cat.patch_ids, jax_cat.patch_ids)
    assert_array_equal(cat.patch_centers_xyz, jax_cat.patch_centers_xyz)
    assert_array_equal(cat.patch_radii, jax_cat.patch_radii)


@pytest.mark.parametrize("rows", [0, 2], ids=["DD", "RD"])
def test_tiles_and_pair_lists_are_identical(measured, rows):
    jax_tiles1, jax_tiles2, jax_pairs = measured["jax_links"]._build_engine_inputs(
        measured["jax_cats"][rows], measured["jax_cats"][1],
        auto=False, binned2=False, mode="nn",
    )
    tiles1, tiles2, pairs = measured["links"]._build_engine_inputs(
        measured["port_cats"][rows], measured["port_cats"][1], mode="nn"
    )
    assert tiles1.lane_data.tobytes() == jax_tiles1.lane_data.tobytes()
    assert tiles2.lane_data.tobytes() == jax_tiles2.lane_data.tobytes()
    assert_array_equal(tiles1.sum_weights, jax_tiles1.sum_weights)
    for name in ("tile1", "tile2", "slot", "slot_patches"):
        assert_array_equal(getattr(pairs, name), getattr(jax_pairs, name))
    assert pairs.num_pairs > 0


@pytest.mark.parametrize("count", ["dd", "rd"])
def test_patch_pair_counts_agree(measured, count):
    jax_counts = getattr(measured["jax_wsp"], count)
    counts = getattr(measured["wsp"], count)
    assert_counts_close(counts.counts.counts, jax_counts.counts.counts)
    for name in ("sum_weights1", "sum_weights2"):
        assert_array_equal(
            getattr(counts.sum_weights, name),
            getattr(jax_counts.sum_weights, name),
        )


@pytest.mark.parametrize("quantity", ["data", "error", "covariance"])
def test_redshift_estimate_agrees(measured, quantity):
    jax_nz = JaxRedshiftData.from_corrfuncs(measured["jax_wsp"])
    nz = RedshiftData.from_corrfuncs(measured["wsp"])
    expected = getattr(jax_nz, quantity)
    assert np.all(np.isfinite(getattr(nz, quantity)))
    assert_allclose(
        getattr(nz, quantity), expected,
        rtol=RTOL, atol=RTOL * np.nanmax(np.abs(expected)),
    )


@pytest.mark.parametrize("rows", [0, 2], ids=["DD", "RD"])
def test_both_packages_agree_with_float64_oracle(measured, rows):
    """Per-slot cumulative counts of both engines against the float64
    scipy oracle of the JAX package, on the port's own tiles."""
    links = measured["links"]
    tiles1, tiles2, pairs = links._build_engine_inputs(
        measured["port_cats"][rows], measured["port_cats"][1], mode="nn"
    )
    xyz1, w1, z1, p1 = _unpack_tileset(tiles1)
    xyz2, w2, _, p2 = _unpack_tileset(tiles2)
    oracle = count_pairs_oracle(
        xyz1, w1, z1, p1, xyz2, w2, None, p2,
        pairs.slot_patches, links.edges.edges,
    )
    table = links.edges.chord2_table
    via_port = count_pairs_tiles(
        tiles1, tiles2, pairs, table, backend="torch", device="cpu"
    )
    via_oracle_backend = count_pairs_tiles(
        tiles1, tiles2, pairs, table, backend="oracle",
        edges_radian=links.edges.edges,
    )
    assert_array_equal(via_oracle_backend, oracle)
    assert_counts_close(via_port, oracle)

    jax_tiles1, jax_tiles2, jax_pairs = measured["jax_links"]._build_engine_inputs(
        measured["jax_cats"][rows], measured["jax_cats"][1],
        auto=False, binned2=False, mode="nn",
    )
    from yet_another_wizz_tpu.ops.paircount import (
        count_pairs_tiles as jax_count_pairs_tiles,
    )

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("YAWT_LANE_ENCODING", "float")
        via_jax = jax_count_pairs_tiles(
            jax_tiles1, jax_tiles2, jax_pairs, table,
            backend="xla", mesh="single",
        )
    assert_counts_close(via_jax, oracle)


def test_default_device_is_cuda(measured):
    """``crosscorrelate`` defaults to the card and says so when there is
    none, instead of running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    config = Configuration.create(**CONFIG)
    reference, unknown, randoms = measured["port_cats"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        crosscorrelate(config, reference, unknown, ref_rand=randoms)


def test_top_level_names(measured):
    assert port.crosscorrelate is crosscorrelate
    assert port.RedshiftData is RedshiftData
    assert port.Catalog is Catalog
