"""The port's ``HistData`` against the JAX package's.

Both packages histogram the same catalog rows: a ``Catalog`` in memory and
a ``LazyCatalog`` over a disk cache, read in blocks of fewer patches than
the catalog has. Counts, jackknife samples and bootstrap samples (same
seed) are bitwise equal to the JAX package's; the bins honour
``Binning.closed`` at the outer edges, and a weight is never taken for
padding (negative weights count as they are)."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import numpy as np
import pytest
from numpy.testing import assert_allclose, assert_array_equal

from yet_another_wizz_tpu.binning import Binning as JaxBinning
from yet_another_wizz_tpu.catalog import Catalog as JaxCatalog
from yet_another_wizz_tpu.catalog import LazyCatalog as JaxLazyCatalog
from yet_another_wizz_tpu.config import Configuration as JaxConfiguration
from yet_another_wizz_tpu.redshifts import HistData as JaxHistData
from yet_another_wizz_tpu_torch import HistData
from yet_another_wizz_tpu_torch.binning import Binning
from yet_another_wizz_tpu_torch.catalog import Catalog, LazyCatalog
from yet_another_wizz_tpu_torch.config import Configuration
from yet_another_wizz_tpu_torch.redshifts import (
    resample_bootstrap,
    resample_jackknife,
)

NUM_PATCHES = 7
CONFIG = dict(rmin=100, rmax=1000, zmin=0.1, zmax=1.0, num_bins=6)


def columns(n=3000, seed=12345):
    rng = np.random.default_rng(seed)
    return dict(
        ra=rng.uniform(10, 20, n), dec=rng.uniform(-5, 5, n),
        redshifts=rng.uniform(0.05, 1.05, n), weights=rng.uniform(0.5, 2.0, n),
    )


@pytest.fixture(scope="module")
def catalogs(tmp_path_factory):
    """The same rows as a ``Catalog`` and a ``LazyCatalog`` of each package."""
    root = tmp_path_factory.mktemp("hist")
    data = columns()
    port = Catalog.from_arrays(
        **data, patch_num=NUM_PATCHES, cache_directory=root / "port",
        device="cpu",
    )
    jax = JaxCatalog.from_arrays(
        **data, patch_num=NUM_PATCHES, cache_directory=root / "jax"
    )
    assert_array_equal(port.patch_ids, jax.patch_ids)
    return dict(
        port=Catalog(root / "port"), jax=JaxCatalog(root / "jax"),
        port_lazy=LazyCatalog(root / "port"),
        jax_lazy=JaxLazyCatalog(root / "jax"),
    )


@pytest.mark.parametrize("method", ["jackknife", "bootstrap"])
@pytest.mark.parametrize("kind", ["memory", "lazy"])
def test_hist_equals_jax(catalogs, kind, method):
    suffix = "_lazy" if kind == "lazy" else ""
    kwargs = dict(method=method, max_resident_patches=3)
    ours = HistData.from_catalog(
        catalogs["port" + suffix], Configuration.create(**CONFIG), **kwargs
    )
    theirs = JaxHistData.from_catalog(
        catalogs["jax" + suffix], JaxConfiguration.create(**CONFIG), **kwargs
    )
    assert_array_equal(ours.binning.edges, theirs.binning.edges)
    assert_array_equal(ours.data, theirs.data)
    assert_array_equal(ours.samples, theirs.samples)
    assert ours.method == theirs.method == method
    expected_samples = NUM_PATCHES if method == "jackknife" else 500
    assert ours.samples.shape == (expected_samples, CONFIG["num_bins"])
    assert_array_equal(ours.covariance, theirs.covariance)


def test_lazy_blocks_equal_in_memory(catalogs):
    config = Configuration.create(**CONFIG)
    memory = HistData.from_catalog(catalogs["port"], config)
    for resident in (1, 3, NUM_PATCHES, None):
        lazy = HistData.from_catalog(
            catalogs["port_lazy"], config, max_resident_patches=resident
        )
        # blocks add per-patch histograms of disjoint rows: the patch rows
        # are summed in the same order, so the totals match to rounding
        assert_allclose(lazy.data, memory.data, rtol=1e-13)
        assert_allclose(lazy.samples, memory.samples, rtol=1e-13)


def test_totals_are_the_weight_sums_in_range(catalogs):
    catalog = catalogs["port"]
    config = Configuration.create(**CONFIG)
    hist = HistData.from_catalog(catalog, config)
    edges = config.binning.binning.edges
    z, w = catalog.redshifts, catalog.weights
    for b in range(len(edges) - 1):
        in_bin = (z > edges[b]) & (z <= edges[b + 1])  # closed right
        assert_allclose(hist.data[b], w[in_bin].sum(), rtol=1e-12)
    expect, _ = np.histogram(z[z > edges[0]], edges, weights=w[z > edges[0]])
    assert_allclose(hist.data, expect, rtol=1e-10)


@pytest.mark.parametrize("closed", ["right", "left"])
def test_exact_edge_values(closed):
    """Values on the outer edges follow ``closed``: closed=right drops
    z == edges[0], closed=left drops z == edges[-1]; a negative weight
    counts as it is."""
    z = np.array([0.2, 0.2, 0.5, 0.8])
    w = np.array([1.0, -0.5, 2.0, 4.0])
    args = (np.linspace(10, 20, 4), np.linspace(-5, 5, 4))
    ids = np.array([0, 0, 1, 1])
    edges = np.array([0.2, 0.5, 0.8])
    ours = HistData.from_catalog(
        Catalog.from_arrays(
            *args, redshifts=z, weights=w, patch_ids=ids, device="cpu"
        ),
        Binning(edges, closed=closed),
    )
    theirs = JaxHistData.from_catalog(
        JaxCatalog.from_arrays(*args, redshifts=z, weights=w, patch_ids=ids),
        JaxBinning(edges, closed=closed),
    )
    assert_array_equal(ours.data, theirs.data)
    # right: (0.2, 0.5], (0.5, 0.8]; left: [0.2, 0.5), [0.5, 0.8)
    assert_allclose(ours.data, [2.0, 4.0] if closed == "right" else [0.5, 2.0])


def test_resampling_helpers_equal_jax():
    from yet_another_wizz_tpu.redshifts import (
        resample_bootstrap as jax_bootstrap,
        resample_jackknife as jax_jackknife,
    )

    obs = np.random.default_rng(3).uniform(0, 1, (6, 4))
    assert_array_equal(resample_jackknife(obs), jax_jackknife(obs))
    assert_array_equal(
        resample_jackknife(obs.T, patch_rows=False),
        jax_jackknife(obs.T, patch_rows=False),
    )
    assert_array_equal(
        resample_bootstrap(obs, 10, seed=7), jax_bootstrap(obs, 10, seed=7)
    )
    for k in range(6):
        expected = np.delete(obs, k, axis=0).sum(axis=0)
        assert_allclose(resample_jackknife(obs)[k], expected)


def test_normalised_equals_jax(catalogs):
    ours = HistData.from_catalog(
        catalogs["port"], Configuration.create(**CONFIG)
    )
    theirs = JaxHistData.from_catalog(
        catalogs["jax"], JaxConfiguration.create(**CONFIG)
    )
    ours, theirs = ours.normalised(), theirs.normalised()
    assert_array_equal(ours.data, theirs.data)
    assert_array_equal(ours.samples, theirs.samples)
    assert_allclose(abs(np.sum(ours.binning.dz * ours.data)), 1.0, rtol=1e-10)


def test_requires_redshifts(tmp_path):
    rng = np.random.default_rng(1)
    catalog = Catalog.from_arrays(
        rng.uniform(10, 20, 100), rng.uniform(-5, 5, 100), patch_num=2,
        cache_directory=tmp_path / "cat", device="cpu",
    )
    config = Configuration.create(**CONFIG)
    for cat in (catalog, LazyCatalog(tmp_path / "cat")):
        with pytest.raises(ValueError, match="redshifts"):
            HistData.from_catalog(cat, config)
    with pytest.raises(TypeError, match="binning"):
        HistData.from_catalog(catalog, object())
