"""The port's autocorrelation (w_ss, Landy-Szalay) against the JAX package.

Both packages run ``autocorrelate`` (DD with binned columns and ordered
patch pairs ``id2 >= id1``, DR and RR with binned columns) and
``crosscorrelate`` on the same mock arrays, then
``RedshiftData.from_corrfuncs(w_sp, ref_corr=w_ss)``. The host pipeline
is a copy, so tile lanes (the bin-coherent ``zmajor`` layout) and
tile-pair lists must be EQUAL; the counts differ only in the order of
float32 sums, hence ``rtol=1e-6`` with ``atol=1e-6 * max|ref|``. The port
runs its plain PyTorch engine (``device="cpu"``), the JAX package its XLA
engine on one device, both with float lanes.
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import numpy as np
import pytest
from numpy.testing import assert_allclose, assert_array_equal

import yet_another_wizz_tpu_torch as port
from test_torch_crosscorrelate import CONFIG, SEED, SIZES, make_catalogs
from yet_another_wizz_tpu.catalog import Catalog as JaxCatalog
from yet_another_wizz_tpu.config import Configuration as JaxConfiguration
from yet_another_wizz_tpu.correlation.measurements import (
    PatchLinkage as JaxPatchLinkage,
    autocorrelate as jax_autocorrelate,
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
    autocorrelate,
    crosscorrelate,
)
from yet_another_wizz_tpu_torch.examples import generate_mock_data
from yet_another_wizz_tpu_torch.ops.paircount import count_pairs_tiles
from yet_another_wizz_tpu_torch.redshifts import RedshiftData

RTOL = 1e-6
COUNTS = {
    # name: (rows, columns or None for an auto count, binned2)
    "DD": (0, None, True),
    "DR": (0, 2, True),
    "RR": (2, None, True),
}


def assert_counts_close(actual, desired):
    desired = np.asarray(desired)
    assert_allclose(
        actual, desired, rtol=RTOL, atol=RTOL * np.abs(desired).max()
    )


@pytest.fixture(scope="module")
def measured():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("YAWT_LANE_ENCODING", "float")
        jax_cats = make_catalogs(JaxCatalog, jax_mock(**SIZES, seed=SEED))
        port_cats = make_catalogs(Catalog, generate_mock_data(**SIZES, seed=SEED))
        jax_config = JaxConfiguration.create(**CONFIG)
        config = Configuration.create(**CONFIG)
        (jax_wss,) = jax_autocorrelate(
            jax_config, jax_cats[0], jax_cats[2], backend="xla", mesh="single"
        )
        (jax_wsp,) = jax_crosscorrelate(
            jax_config, *jax_cats[:2], ref_rand=jax_cats[2], backend="xla",
            mesh="single",
        )
        (wss,) = autocorrelate(config, port_cats[0], port_cats[2], device="cpu")
        (wsp,) = crosscorrelate(
            config, *port_cats[:2], ref_rand=port_cats[2], device="cpu"
        )
        return dict(
            jax_cats=jax_cats,
            port_cats=port_cats,
            jax_links=JaxPatchLinkage.from_catalogs(
                jax_config, jax_cats[0], jax_cats[2]
            ),
            links=PatchLinkage.from_catalogs(config, port_cats[0], port_cats[2]),
            jax_wss=jax_wss,
            wss=wss,
            jax_wsp=jax_wsp,
            wsp=wsp,
        )


def engine_inputs(links, cats, name):
    rows, cols, binned2 = COUNTS[name]
    auto = cols is None
    return links._build_engine_inputs(
        cats[rows], cats[rows if auto else cols], auto=auto, binned2=binned2,
        mode="nn",
    )


@pytest.mark.parametrize("name", list(COUNTS))
def test_tiles_and_pair_lists_are_identical(measured, name):
    jax_tiles1, jax_tiles2, jax_pairs = engine_inputs(
        measured["jax_links"], measured["jax_cats"], name
    )
    tiles1, tiles2, pairs = engine_inputs(
        measured["links"], measured["port_cats"], name
    )
    assert tiles2.binned  # equal-bin counting: binned columns
    assert tiles1.lane_data.tobytes() == jax_tiles1.lane_data.tobytes()
    assert tiles2.lane_data.tobytes() == jax_tiles2.lane_data.tobytes()
    assert_array_equal(tiles2.tile_zmin, jax_tiles2.tile_zmin)
    assert_array_equal(tiles2.tile_zmax, jax_tiles2.tile_zmax)
    for field in ("tile1", "tile2", "slot", "slot_patches"):
        assert_array_equal(getattr(pairs, field), getattr(jax_pairs, field))
    assert pairs.num_pairs > 0
    if COUNTS[name][1] is None:  # ordered patch pairs only
        assert np.all(pairs.slot_patches[:, 1] >= pairs.slot_patches[:, 0])


@pytest.mark.parametrize("count", ["dd", "dr", "rr"])
def test_patch_pair_counts_agree(measured, count):
    jax_counts = getattr(measured["jax_wss"], count)
    counts = getattr(measured["wss"], count)
    assert counts.auto == jax_counts.auto
    assert_counts_close(counts.counts.counts, jax_counts.counts.counts)
    for name in ("sum_weights1", "sum_weights2"):
        assert_array_equal(
            getattr(counts.sum_weights, name),
            getattr(jax_counts.sum_weights, name),
        )


def test_landy_szalay_samples_agree(measured):
    jax_data = measured["jax_wss"].sample()
    data = measured["wss"].sample()
    assert measured["wss"].get_estimator().name == "LS"
    for field in ("data", "samples"):
        expected = getattr(jax_data, field)
        assert_allclose(
            getattr(data, field), expected, rtol=RTOL,
            atol=RTOL * np.nanmax(np.abs(expected)),
        )


@pytest.mark.parametrize("quantity", ["data", "error", "covariance"])
def test_redshift_estimate_with_ref_corr_agrees(measured, quantity):
    jax_nz = JaxRedshiftData.from_corrfuncs(
        measured["jax_wsp"], ref_corr=measured["jax_wss"]
    )
    nz = RedshiftData.from_corrfuncs(measured["wsp"], ref_corr=measured["wss"])
    expected = getattr(jax_nz, quantity)
    assert np.all(np.isfinite(getattr(nz, quantity)))
    assert_allclose(
        getattr(nz, quantity), expected,
        rtol=RTOL, atol=RTOL * np.nanmax(np.abs(expected)),
    )


@pytest.mark.parametrize("name", ["DD", "DR"])
def test_binned_columns_agree_with_float64_oracle(measured, name):
    """Per-slot cumulative counts of the plain engine with binned columns
    against the JAX package's float64 scipy oracle."""
    links = measured["links"]
    tiles1, tiles2, pairs = engine_inputs(links, measured["port_cats"], name)
    xyz1, w1, z1, p1 = _unpack_tileset(tiles1)
    xyz2, w2, z2, p2 = _unpack_tileset(tiles2)
    oracle = count_pairs_oracle(
        xyz1, w1, z1, p1, xyz2, w2, z2, p2,
        pairs.slot_patches, links.edges.edges,
    )
    via_port = count_pairs_tiles(
        tiles1, tiles2, pairs, links.edges.chord2_table, device="cpu"
    )
    assert_counts_close(via_port, oracle)


def test_autocorrelate_without_rr(measured):
    config = Configuration.create(**CONFIG)
    reference, _, randoms = measured["port_cats"]
    (wss,) = autocorrelate(config, reference, randoms, count_rr=False, device="cpu")
    assert wss.rr is None
    assert_counts_close(wss.dd.counts.counts, measured["wss"].dd.counts.counts)


def test_default_device_is_cuda(measured):
    """``autocorrelate`` defaults to the card and says so when there is
    none, instead of running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    config = Configuration.create(**CONFIG)
    reference, _, randoms = measured["port_cats"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        autocorrelate(config, reference, randoms)


def test_top_level_names():
    assert port.autocorrelate is autocorrelate
    assert port.correlation.autocorrelate is autocorrelate
    assert port.autocorrelate_scalar is port.correlation.autocorrelate_scalar
    assert port.crosscorrelate_scalar is port.correlation.crosscorrelate_scalar
