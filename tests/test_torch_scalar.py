"""The port's scalar-field (kappa) measurements against the JAX package.

``kn``/``kk`` counts carry signed pair weights (kappa * weight, kappa
drawn around 0.1 with spread 0.3, so many are negative): padding is the
only weight-0 point, and no engine may treat ``w <= 0`` as padding. Both
packages run the same measurement on the same mock arrays; the port its
plain PyTorch engine on the CPU, the JAX package its XLA engine. Counts
agree to ``rtol=1e-6, atol=1e-6 * max|ref|`` (float32 summation order).
``ScalarCorrFunc`` samples and the port's counts against the float64
oracle are held to the tolerances of ``tests/test_scalar_correlations.py``
(samples ``rtol=1e-4, atol=1e-7``, oracle counts ``rtol=1e-4, atol=1.0``):
a kappa count is a sum of signed terms, and its cancellation magnifies
the relative float32 error of a small estimate.
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import numpy as np
import pytest
from numpy.testing import assert_allclose, assert_array_equal

from yet_another_wizz_tpu.catalog import Catalog as JaxCatalog
from yet_another_wizz_tpu.config import Configuration as JaxConfiguration
from yet_another_wizz_tpu.correlation import measurements as jax_measurements
from yet_another_wizz_tpu.examples import generate_mock_data as jax_mock
from yet_another_wizz_tpu_torch.catalog import Catalog
from yet_another_wizz_tpu_torch.config import Configuration
from yet_another_wizz_tpu_torch.correlation import measurements
from yet_another_wizz_tpu_torch.correlation.corrfunc import ScalarCorrFunc
from yet_another_wizz_tpu_torch.examples import generate_mock_data

SIZES = dict(num_reference=3000, num_unknown=5000, num_randoms=6000)
CONFIG = dict(rmin=500, rmax=3000, unit="kpc", zmin=0.15, zmax=1.0, num_bins=4)
RTOL = 1e-6
SAMPLE_RTOL = 1e-4


def assert_counts_close(actual, desired, rtol=RTOL):
    desired = np.asarray(desired)
    assert_allclose(actual, desired, rtol=rtol, atol=rtol * np.abs(desired).max())


def make_catalogs(catalog_cls, mock):
    rng = np.random.default_rng(5)
    ref_data = dict(mock["reference"])
    ref_data["kappa"] = rng.normal(0.1, 0.3, len(ref_data["ra"]))
    unk_data = dict(mock["unknown"])
    unk_data["kappa"] = rng.normal(0.05, 0.2, len(unk_data["ra"]))
    reference = catalog_cls.from_arrays(**ref_data, degrees=False, patch_num=4)
    centers = reference.get_centers()
    unknown = catalog_cls.from_arrays(
        **unk_data, degrees=False, patch_centers=centers
    )
    randoms = catalog_cls.from_arrays(
        **mock["randoms"], degrees=False, patch_centers=centers
    )
    return reference, unknown, randoms


@pytest.fixture(scope="module")
def packages():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("YAWT_LANE_ENCODING", "float")
        jax_cats = make_catalogs(JaxCatalog, jax_mock(**SIZES, seed=11))
        cats = make_catalogs(Catalog, generate_mock_data(**SIZES, seed=11))
        jax_config = JaxConfiguration.create(**CONFIG)
        config = Configuration.create(**CONFIG)
        jax_run = dict(backend="xla", mesh="single")
        run = dict(device="cpu")
        return dict(
            jax=dict(
                cats=jax_cats,
                links=jax_measurements.PatchLinkage.from_catalogs(
                    jax_config, *jax_cats[:2]
                ),
                auto=jax_measurements.autocorrelate_scalar(
                    jax_config, jax_cats[0], **jax_run
                ),
                cross=jax_measurements.crosscorrelate_scalar(
                    jax_config, *jax_cats[:2], **jax_run
                ),
                cross_rand=jax_measurements.crosscorrelate_scalar(
                    jax_config, *jax_cats[:2], unk_rand=jax_cats[2], **jax_run
                ),
                run=jax_run,
            ),
            port=dict(
                cats=cats,
                links=measurements.PatchLinkage.from_catalogs(config, *cats[:2]),
                auto=measurements.autocorrelate_scalar(config, cats[0], **run),
                cross=measurements.crosscorrelate_scalar(config, *cats[:2], **run),
                cross_rand=measurements.crosscorrelate_scalar(
                    config, *cats[:2], unk_rand=cats[2], **run
                ),
                run=run,
            ),
        )


@pytest.mark.parametrize("mode", ["kn", "kk", "nk"])
def test_scalar_counts_agree(packages, mode):
    counts = {}
    for name, pkg in packages.items():
        reference, unknown, _ = pkg["cats"]
        (counts[name],) = pkg["links"].count_pairs(
            reference, unknown, mode=mode, **pkg["run"]
        )
    assert_counts_close(counts["port"].counts.counts, counts["jax"].counts.counts)
    assert np.any(counts["port"].counts.counts < 0)  # signed pair weights


@pytest.mark.parametrize("mode", ["kn", "kk"])
def test_scalar_counts_agree_with_oracle(packages, mode):
    pkg = packages["port"]
    reference, unknown, _ = pkg["cats"]
    engine = pkg["links"].count_pairs(reference, unknown, mode=mode, device="cpu")
    oracle = pkg["links"].count_pairs(reference, unknown, mode=mode, backend="oracle")
    assert_allclose(
        engine[0].counts.counts, oracle[0].counts.counts, rtol=1e-4, atol=1.0
    )


@pytest.mark.parametrize("measurement", ["auto", "cross", "cross_rand"])
def test_scalar_corrfunc_samples_agree(packages, measurement):
    (corr,) = packages["port"][measurement]
    (jax_corr,) = packages["jax"][measurement]
    assert isinstance(corr, ScalarCorrFunc)
    assert corr.get_estimator().name == "SC"
    # NormalisedScalarCounts: the kappa counts and their nn normalisation
    assert_counts_close(corr.dd._counts.counts, jax_corr.dd._counts.counts)
    assert_counts_close(corr.dd._norm.counts, jax_corr.dd._norm.counts)
    data, expected = corr.sample(), jax_corr.sample()
    assert np.all(np.isfinite(data.data))
    for field in ("data", "samples"):
        assert_allclose(
            getattr(data, field), getattr(expected, field),
            rtol=SAMPLE_RTOL, atol=1e-7,
        )


def test_scalar_normalisation_equals_jax(packages):
    config = Configuration.create(**CONFIG)
    norm = measurements.compute_scalar_normalisation(
        packages["port"]["cats"][0], config
    )
    expected = jax_measurements.compute_scalar_normalisation(
        packages["jax"]["cats"][0], JaxConfiguration.create(**CONFIG)
    )
    assert_array_equal(norm._counts.counts, expected._counts.counts)
    assert_array_equal(norm._norm.counts, expected._norm.counts)
    with pytest.raises(ValueError, match="kappa"):
        measurements.compute_scalar_normalisation(
            packages["port"]["cats"][2], config
        )
