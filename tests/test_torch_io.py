"""Files of the port and of the JAX package read back in the other, and the
port's public names.

``CorrFunc`` and ``ScalarCorrFunc`` (HDF5), ``HistData`` and
``RedshiftData`` (the ASCII ``.dat`` / ``.smp`` / ``.cov`` triple) written
by one package load in the other with equal values; ``load_corrfunc``
dispatches on the stored container type; the JAX package's committed
example products load in the port (read only). The port's ``__all__``
equals the JAX package's, at the top level and for ``catalog``."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import numpy as np
import pytest
from numpy.testing import assert_array_equal

import yet_another_wizz_tpu as jax_package
import yet_another_wizz_tpu.catalog as jax_catalog_module
import yet_another_wizz_tpu.parallel as jax_parallel_module
import yet_another_wizz_tpu.parallel.distributed as jax_distributed_module
import yet_another_wizz_tpu_torch as port_package
import yet_another_wizz_tpu_torch.catalog as port_catalog_module
import yet_another_wizz_tpu_torch.parallel as port_parallel_module
import yet_another_wizz_tpu_torch.parallel.distributed as port_distributed_module
from yet_another_wizz_tpu.catalog import Catalog as JaxCatalog
from yet_another_wizz_tpu.config import Configuration as JaxConfiguration
from yet_another_wizz_tpu.correlation.corrfunc import (
    CorrFunc as JaxCorrFunc,
    ScalarCorrFunc as JaxScalarCorrFunc,
    load_corrfunc as jax_load_corrfunc,
)
from yet_another_wizz_tpu.examples import _PACKAGE_PRODUCTS
from yet_another_wizz_tpu.redshifts import HistData as JaxHistData
from yet_another_wizz_tpu.redshifts import RedshiftData as JaxRedshiftData
from yet_another_wizz_tpu_torch import (
    Catalog,
    Configuration,
    CorrFunc,
    HistData,
    RedshiftData,
    ScalarCorrFunc,
    crosscorrelate_scalar,
    load_corrfunc,
)
from yet_another_wizz_tpu_torch.examples import generate_mock_data

CONFIG = dict(rmin=500, rmax=3000, unit="kpc", zmin=0.15, zmax=1.0, num_bins=4)


def hdf_dump(path):
    """Every dataset of an HDF5 file by its path, as numpy arrays."""
    import h5py

    found = {}
    with h5py.File(path, "r") as f:
        f.visititems(
            lambda name, item: found.__setitem__(name, item[()])
            if isinstance(item, h5py.Dataset) else None
        )
    return found


def assert_same_counts(ours, theirs, tmp_path):
    """Equal containers: the same type name, and the HDF5 files each package
    writes of them hold the same datasets and values."""
    assert type(ours).__name__ == type(theirs).__name__
    ours.to_file(tmp_path / "check_ours.hdf")
    theirs.to_file(tmp_path / "check_theirs.hdf")
    mine, other = hdf_dump(tmp_path / "check_ours.hdf"), hdf_dump(
        tmp_path / "check_theirs.hdf"
    )
    assert sorted(mine) == sorted(other)
    for name, value in mine.items():
        assert_array_equal(value, other[name], err_msg=name)
    assert_array_equal(ours.sample().data, theirs.sample().data)
    assert_array_equal(ours.sample().samples, theirs.sample().samples)


@pytest.fixture(scope="module")
def scalar_corr():
    """A kappa cross-correlation measured by the port on the CPU."""
    mock = generate_mock_data(1500, 2500, 3000, seed=4)
    ref = dict(mock["reference"])
    ref["kappa"] = np.random.default_rng(4).normal(0.1, 0.3, len(ref["ra"]))
    reference = Catalog.from_arrays(**ref, degrees=False, patch_num=4, device="cpu")
    centers = reference.get_centers()
    unknown = Catalog.from_arrays(
        **mock["unknown"], degrees=False, patch_centers=centers, device="cpu"
    )
    randoms = Catalog.from_arrays(
        **mock["randoms"], degrees=False, patch_centers=centers, device="cpu"
    )
    (corr,) = crosscorrelate_scalar(
        Configuration.create(**CONFIG), reference, unknown, unk_rand=randoms,
        device="cpu",
    )
    return corr


@pytest.mark.parametrize("name", ["cross", "auto"])
def test_committed_corrfuncs_load_in_the_port(tmp_path, name):
    path = _PACKAGE_PRODUCTS / f"{name}.hdf"
    ours = CorrFunc.from_file(path)
    assert_same_counts(ours, JaxCorrFunc.from_file(path), tmp_path)
    assert_same_counts(load_corrfunc(path), ours, tmp_path)


@pytest.mark.parametrize("name", ["cross", "auto"])
def test_corrfunc_files_cross_packages(tmp_path, name):
    theirs = JaxCorrFunc.from_file(_PACKAGE_PRODUCTS / f"{name}.hdf")
    ours = CorrFunc.from_file(_PACKAGE_PRODUCTS / f"{name}.hdf")
    ours.to_file(tmp_path / "port.hdf")
    theirs.to_file(tmp_path / "jax.hdf")
    assert_same_counts(JaxCorrFunc.from_file(tmp_path / "port.hdf"), theirs, tmp_path)
    assert_same_counts(CorrFunc.from_file(tmp_path / "jax.hdf"), ours, tmp_path)
    assert type(jax_load_corrfunc(tmp_path / "port.hdf")) is JaxCorrFunc


def test_scalar_corrfunc_files_cross_packages(tmp_path, scalar_corr):
    scalar_corr.to_file(tmp_path / "port.hdf")
    theirs = JaxScalarCorrFunc.from_file(tmp_path / "port.hdf")
    assert_same_counts(theirs, scalar_corr, tmp_path)
    assert type(jax_load_corrfunc(tmp_path / "port.hdf")) is JaxScalarCorrFunc
    theirs.to_file(tmp_path / "jax.hdf")
    loaded = load_corrfunc(tmp_path / "jax.hdf")
    assert type(loaded) is ScalarCorrFunc
    assert_same_counts(loaded, scalar_corr, tmp_path)
    # a plain CorrFunc file dispatches to CorrFunc
    assert type(load_corrfunc(_PACKAGE_PRODUCTS / "cross.hdf")) is CorrFunc
    with pytest.raises(TypeError):
        CorrFunc.from_file(tmp_path / "jax.hdf")


def assert_same_data(ours, theirs):
    assert_array_equal(ours.binning.edges, theirs.binning.edges)
    assert str(ours.binning.closed) == str(theirs.binning.closed)
    assert_array_equal(ours.data, theirs.data)
    assert_array_equal(ours.samples, theirs.samples)
    assert str(ours.method) == str(theirs.method)


def test_committed_estimate_loads_in_the_port():
    prefix = _PACKAGE_PRODUCTS / "estimate"
    ours, theirs = RedshiftData.from_files(prefix), JaxRedshiftData.from_files(prefix)
    assert_same_data(ours, theirs)
    assert_array_equal(ours.covariance, theirs.covariance)
    assert ours.num_bins == 11 and np.all(np.isfinite(ours.data))


@pytest.mark.parametrize("method", ["jackknife", "bootstrap"])
def test_histdata_files_cross_packages(tmp_path, method):
    rng = np.random.default_rng(8)
    n = 2000
    columns = dict(
        ra=rng.uniform(10, 20, n), dec=rng.uniform(-5, 5, n),
        redshifts=rng.uniform(0.1, 1.0, n), weights=rng.uniform(0.5, 2.0, n),
    )
    ids = rng.integers(0, 5, n)
    config = dict(rmin=100, rmax=1000, zmin=0.1, zmax=1.0, num_bins=6)
    ours = HistData.from_catalog(
        Catalog.from_arrays(**columns, patch_ids=ids, device="cpu"),
        Configuration.create(**config), method=method,
    )
    theirs = JaxHistData.from_catalog(
        JaxCatalog.from_arrays(**columns, patch_ids=ids),
        JaxConfiguration.create(**config), method=method,
    )
    ours.to_files(tmp_path / "port")
    theirs.to_files(tmp_path / "jax")
    for suffix in (".dat", ".smp", ".cov"):
        assert (tmp_path / f"port{suffix}").read_bytes() == (
            tmp_path / f"jax{suffix}"
        ).read_bytes()
    # the text holds fewer digits than float64: compare what each reads
    loaded = HistData.from_files(tmp_path / "jax")
    assert_same_data(JaxHistData.from_files(tmp_path / "port"), loaded)
    assert_same_data(HistData.from_files(tmp_path / "port"), loaded)
    assert_array_equal(ours.data, theirs.data)


def test_redshiftdata_files_cross_packages(tmp_path):
    theirs = JaxRedshiftData.from_files(_PACKAGE_PRODUCTS / "estimate")
    ours = RedshiftData.from_files(_PACKAGE_PRODUCTS / "estimate")
    ours.to_files(tmp_path / "port")
    theirs.to_files(tmp_path / "jax")
    for suffix in (".dat", ".smp", ".cov"):
        assert (tmp_path / f"port{suffix}").read_bytes() == (
            tmp_path / f"jax{suffix}"
        ).read_bytes()
    assert_same_data(RedshiftData.from_files(tmp_path / "jax"), ours)


def test_patch_reads_a_cache_as_the_jax_patch_does(tmp_path):
    """``catalog.Patch`` of either package on a patch directory the port
    wrote: the same metadata and columns; without ``meta.yml`` both compute
    and write the same one."""
    from yet_another_wizz_tpu.catalog import Patch as JaxPatch
    from yet_another_wizz_tpu_torch.catalog import Patch

    rng = np.random.default_rng(2)
    n = 500
    Catalog.from_arrays(
        rng.uniform(10, 20, n), rng.uniform(-5, 5, n),
        redshifts=rng.uniform(0.1, 1.0, n), weights=rng.uniform(0.5, 2.0, n),
        patch_num=3, cache_directory=tmp_path / "cache", device="cpu",
    )
    directory = tmp_path / "cache" / "patch_1"
    for drop_meta in (False, True):
        if drop_meta:
            (directory / "meta.yml").unlink()
        ours = Patch(directory)
        meta = (directory / "meta.yml").read_bytes()
        if drop_meta:
            (directory / "meta.yml").unlink()
        theirs = JaxPatch(directory)
        assert (directory / "meta.yml").read_bytes() == meta
        assert ours.meta.num_records == theirs.meta.num_records > 0
        assert ours.meta.sum_weights == theirs.meta.sum_weights
        assert_array_equal(ours.meta.center.data, theirs.meta.center.data)
        assert_array_equal(ours.coords.data, theirs.coords.data)
        for name in ("weights", "redshifts"):
            assert_array_equal(getattr(ours, name), getattr(theirs, name))
        assert ours.kappa is None and theirs.kappa is None
        assert (ours.has_weights, ours.has_redshifts) == (True, True)


@pytest.mark.parametrize(
    "port, jax",
    [
        (port_package, jax_package),
        (port_catalog_module, jax_catalog_module),
        (port_parallel_module, jax_parallel_module),
        (port_distributed_module, jax_distributed_module),
    ],
    ids=["top level", "catalog", "parallel", "parallel.distributed"],
)
def test_public_names_equal_jax(port, jax):
    assert sorted(port.__all__) == sorted(jax.__all__)
    for name in port.__all__:
        assert getattr(port, name) is not None
