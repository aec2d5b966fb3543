"""The port's example data (``yet_another_wizz_tpu_torch.examples``): the
counterparts of ``tests/test_example_products.py`` and
``tests/test_golden_example.py``.

The port commits byte copies of the JAX package's mock products; a fresh
offline install loads ``examples.cross/auto/estimate`` from them without
computing anything, and they match the golden n(z). The mock survey files
of ``ExampleData.ensure_files`` are the JAX package's byte for byte. The
golden test recomputes the products with the port on the CPU (marked
``slow``, as the JAX one is).
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import importlib

import numpy as np
import pytest
from numpy.testing import assert_array_almost_equal

from yet_another_wizz_tpu.examples import _PACKAGE_PRODUCTS as JAX_PRODUCTS
from yet_another_wizz_tpu_torch.examples import _PACKAGE_PRODUCTS

PRODUCTS = ("cross.hdf", "auto.hdf", "estimate.dat", "estimate.smp", "estimate.cov")


def _golden_module():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).parent / "test_golden_example.py"
    spec = importlib.util.spec_from_file_location("_golden_example", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def offline_examples(tmp_path, monkeypatch):
    """The examples module resolved against an empty cache with the mock
    forced: whatever loads must come from the committed files."""
    monkeypatch.setenv("YAWT_EXAMPLE_CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("YAWT_EXAMPLE_FORCE_MOCK", "1")
    import yet_another_wizz_tpu_torch.examples as examples

    importlib.reload(examples)
    yield examples
    monkeypatch.undo()
    importlib.reload(examples)


@pytest.mark.parametrize("name", PRODUCTS)
def test_products_are_the_jax_packages(name):
    assert (_PACKAGE_PRODUCTS / name).read_bytes() == (JAX_PRODUCTS / name).read_bytes()


def test_products_resolve_to_package_files(offline_examples):
    assert not offline_examples.USES_REAL_DATA
    assert offline_examples.PATH.cross.parent == _PACKAGE_PRODUCTS
    assert offline_examples.PATH.auto.parent == _PACKAGE_PRODUCTS
    for name in ("estimate.dat", "estimate.smp", "estimate.cov"):
        assert (_PACKAGE_PRODUCTS / name).exists()


def test_committed_products_load_without_computation(offline_examples, tmp_path):
    cross = offline_examples.cross
    auto = offline_examples.auto
    estimate = offline_examples.estimate
    assert cross.dd.num_bins == 11
    assert auto.dd.num_bins == 11
    assert estimate.num_bins == 11
    assert np.all(np.isfinite(estimate.data))
    assert np.array_equal(offline_examples.patched_count.get_array(), cross.dd.counts.get_array())
    assert offline_examples.config.binning.num_bins == 11
    # nothing was measured into the cache: the load was file-only
    assert not (tmp_path / "cache" / "cross.hdf").exists()
    # the committed products are read-only
    with pytest.raises(RuntimeError, match="read-only"):
        offline_examples.ExampleData.build_products(force=True, device="cpu")


def test_committed_estimate_matches_golden(offline_examples):
    golden = _golden_module()
    estimate = offline_examples.estimate
    assert_array_almost_equal(estimate.data, golden.GOLDEN_DATA, decimal=5)
    assert_array_almost_equal(estimate.error, golden.GOLDEN_ERROR, decimal=5)


def test_committed_products_are_consistent(offline_examples):
    """The estimate equals what the committed cross/auto recombine to."""
    from yet_another_wizz_tpu_torch.redshifts import RedshiftData

    recombined = RedshiftData.from_corrfuncs(
        offline_examples.cross, offline_examples.auto
    )
    # the committed estimate round-trips through the ASCII .dat format,
    # which stores ~6 significant decimals
    assert_array_almost_equal(
        recombined.data, offline_examples.estimate.data, decimal=5
    )


def test_mock_survey_files_are_the_jax_packages(tmp_path, monkeypatch):
    """``ExampleData.ensure_files`` writes the JAX package's mock parquet
    files byte for byte (both generate the same mock from the same seed)."""
    import yet_another_wizz_tpu.examples as jax_examples
    import yet_another_wizz_tpu_torch.examples as examples

    monkeypatch.setenv("YAWT_EXAMPLE_FORCE_MOCK", "1")
    try:
        for module, name in ((examples, "port"), (jax_examples, "jax")):
            monkeypatch.setenv("YAWT_EXAMPLE_CACHE", str(tmp_path / name))
            module._refresh_paths()
            module.ExampleData.ensure_files()
    finally:
        monkeypatch.undo()
        examples._refresh_paths()
        jax_examples._refresh_paths()
    for name in ("mock_data.pqt", "mock_rand.pqt", "mock_unknown.pqt"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


@pytest.mark.slow
def test_example_estimate_reproduces_golden_values(tmp_path, monkeypatch):
    """The port measures the mock example afresh on the CPU (kmeans
    patches, ``crosscorrelate`` and ``autocorrelate`` with its plain
    engine) and reproduces the golden n(z)."""
    monkeypatch.setenv("YAWT_EXAMPLE_CACHE", str(tmp_path / "examples"))
    monkeypatch.setenv("YAWT_EXAMPLE_FORCE_MOCK", "1")
    monkeypatch.setenv("YAWT_EXAMPLE_IGNORE_PACKAGED", "1")
    import yet_another_wizz_tpu_torch.examples as examples

    try:
        importlib.reload(examples)
        assert examples.PATH.cross.parent == tmp_path / "examples"
        examples.ExampleData.build_products(device="cpu")
        estimate = examples.estimate
    finally:
        monkeypatch.undo()
        importlib.reload(examples)
    golden = _golden_module()
    assert estimate.num_bins == 11
    assert estimate.num_samples == 11
    assert_array_almost_equal(estimate.data, golden.GOLDEN_DATA, decimal=5)
    assert_array_almost_equal(estimate.error, golden.GOLDEN_ERROR, decimal=5)
    assert_array_almost_equal(estimate.samples[0], golden.GOLDEN_SAMPLE_0, decimal=5)
