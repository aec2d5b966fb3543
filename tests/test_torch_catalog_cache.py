"""The port's catalog caches, file and random constructors and lazy
catalogs against the JAX package's.

Both packages write the same patch cache (``patch_{i}/data.bin`` +
``meta.yml`` + ``patch_ids.bin``), so a cache written by one opens in the
other with equal rows, patch ids, centers and radii. Host code only: the
patch assignment of these small catalogs runs on the host in both packages
(``device="cpu"`` keeps the port off the card)."""

import weakref

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal
from torch_cli_cases import write_fits

from yet_another_wizz_tpu.catalog import Catalog as JaxCatalog
from yet_another_wizz_tpu.catalog import LazyCatalog as JaxLazyCatalog
from yet_another_wizz_tpu.randoms import BoxRandoms as JaxBoxRandoms
from yet_another_wizz_tpu_torch.catalog import Catalog, LazyCatalog
from yet_another_wizz_tpu_torch.examples import generate_mock_data
from yet_another_wizz_tpu_torch.randoms import BoxRandoms

SIZES = dict(num_reference=4000, num_unknown=6000, num_randoms=9000)
NUM_PATCHES = 12


@pytest.fixture(scope="module")
def mock():
    return generate_mock_data(**SIZES, seed=21)


def assert_same_catalog(actual, expected):
    """Equal rows, patch ids and patch geometry (either package)."""
    for name in ("ra", "dec", "weights", "redshifts", "patch_ids", "xyz"):
        assert_array_equal(getattr(actual, name), getattr(expected, name))
    assert_array_equal(actual.patch_centers_xyz, expected.patch_centers_xyz)
    assert_array_equal(actual.patch_radii, expected.patch_radii)
    assert actual.get_num_records() == expected.get_num_records()


@pytest.fixture(scope="module")
def caches(mock, tmp_path_factory):
    """The reference sample written by each package from the same arrays."""
    root = tmp_path_factory.mktemp("caches")
    port = Catalog.from_arrays(
        **mock["reference"], degrees=False, patch_num=NUM_PATCHES,
        cache_directory=root / "port", device="cpu",
    )
    jax = JaxCatalog.from_arrays(
        **mock["reference"], degrees=False, patch_num=NUM_PATCHES,
        cache_directory=root / "jax",
    )
    return dict(port=port, jax=jax, root=root)


def test_cache_round_trip(caches):
    port = caches["port"]
    reopened = Catalog(caches["root"] / "port")
    assert reopened.cache_directory == caches["root"] / "port"
    # the cache is patch-major: compare the patch-sorted rows
    order = np.argsort(port.patch_ids, kind="stable")
    for name in ("ra", "dec", "weights", "redshifts", "patch_ids"):
        assert_array_equal(getattr(reopened, name), getattr(port, name)[order])
    # meta.yml stores the centers as (ra, dec): back in xyz they move by
    # an ulp, in both packages alike (see the next test)
    assert_allclose(reopened.patch_centers_xyz, port.patch_centers_xyz, rtol=0, atol=1e-15)
    assert_allclose(reopened.patch_radii, port.patch_radii, rtol=1e-14)
    assert reopened.get_num_records() == port.get_num_records()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_caches_open_in_both_packages(caches, writer):
    """A cache written by either package opens in both, equally."""
    directory = caches["root"] / writer
    assert_same_catalog(Catalog(directory), JaxCatalog(directory))
    assert_array_equal(caches["port"].patch_ids, caches["jax"].patch_ids)
    assert (directory / "patch_ids.bin").read_bytes() == (
        caches["root"] / "jax" / "patch_ids.bin"
    ).read_bytes()


def test_cache_files_are_byte_identical(caches):
    for pid in range(NUM_PATCHES):
        for name in ("data.bin", "meta.yml"):
            ours = caches["root"] / "port" / f"patch_{pid}" / name
            theirs = caches["root"] / "jax" / f"patch_{pid}" / name
            assert ours.read_bytes() == theirs.read_bytes()


def test_existing_cache_needs_overwrite(caches, mock):
    with pytest.raises(FileExistsError):
        Catalog.from_arrays(
            **mock["reference"], degrees=False, patch_num=NUM_PATCHES,
            cache_directory=caches["root"] / "port", device="cpu",
        )


def test_lazy_catalog_equals_jax(caches):
    directory = caches["root"] / "port"
    lazy, jax_lazy = LazyCatalog(directory), JaxLazyCatalog(directory)
    assert lazy.num_patches == jax_lazy.num_patches == NUM_PATCHES
    assert lazy.get_num_records() == jax_lazy.get_num_records()
    assert lazy.get_sum_weights() == jax_lazy.get_sum_weights()
    assert_array_equal(lazy.patch_centers_xyz, jax_lazy.patch_centers_xyz)
    assert_array_equal(lazy.patch_radii, jax_lazy.patch_radii)
    assert (lazy.has_weights, lazy.has_redshifts, lazy.has_kappa) == (
        True, True, False
    )
    resident = Catalog(directory)
    for lo, hi in ((0, 5), (5, 6), (6, NUM_PATCHES)):
        block, expected = lazy.load_block(lo, hi), jax_lazy.load_block(lo, hi)
        in_memory = resident.load_block(lo, hi)
        for name in ("xyz", "patch_ids", "weights", "redshifts"):
            assert_array_equal(getattr(block, name), getattr(expected, name))
            assert_array_equal(getattr(block, name), getattr(in_memory, name))
        assert block.kappa is None
    with pytest.raises(NotImplementedError, match="max_resident_patches"):
        lazy.get_tiles(None)


def test_catalogs_are_weakly_referenceable(caches):
    for catalog in (caches["port"], LazyCatalog(caches["root"] / "port")):
        ref = weakref.ref(catalog)
        assert ref() is catalog


def test_from_random_equals_jax(caches):
    centers = caches["port"].get_centers()
    args = (30.0, 60.0, -10.0, 10.0)
    ours = Catalog.from_random(
        None, BoxRandoms(*args, seed=199), 5000, patch_centers=centers,
        device="cpu",
    )
    theirs = JaxCatalog.from_random(
        None, JaxBoxRandoms(*args, seed=199), 5000,
        patch_centers=caches["jax"].get_centers(),
    )
    assert_same_catalog(ours, theirs)


FILE_COLUMNS = dict(
    ra_name="RA", dec_name="DEC", weight_name="W", redshift_name="Z"
)


@pytest.fixture(scope="module")
def table(mock):
    unknown = mock["unknown"]
    return dict(
        RA=np.rad2deg(unknown["ra"]), DEC=np.rad2deg(unknown["dec"]),
        W=unknown["weights"], Z=unknown["redshifts"],
    )


def write_table(path, table, fmt):
    if fmt == "fits":
        write_fits(path, table)
    elif fmt == "csv":
        pd = pytest.importorskip("pandas")
        pd.DataFrame(table).to_csv(path, index=False)
    elif fmt == "parquet":
        pytest.importorskip("pyarrow")
        pd = pytest.importorskip("pandas")
        pd.DataFrame(table).to_parquet(path)
    else:
        h5py = pytest.importorskip("h5py")
        with h5py.File(path, "w") as f:
            for name, values in table.items():
                f.create_dataset(name, data=values)


@pytest.mark.parametrize(
    "fmt, suffix",
    [("fits", "fits"), ("csv", "csv"), ("parquet", "parquet"), ("hdf5", "hdf5")],
)
@pytest.mark.parametrize("streaming", [False, True], ids=["memory", "streaming"])
def test_from_file_equals_jax(caches, table, tmp_path, fmt, suffix, streaming):
    path = tmp_path / f"unknown.{suffix}"
    write_table(path, table, fmt)
    kwargs = dict(FILE_COLUMNS, chunksize=2000 if streaming else None)
    ours = Catalog.from_file(
        tmp_path / "port", path, patch_centers=caches["port"].get_centers(),
        streaming=streaming, device="cpu", **kwargs,
    )
    theirs = JaxCatalog.from_file(
        tmp_path / "jax", path, patch_centers=caches["jax"].get_centers(),
        streaming=streaming, **kwargs,
    )
    assert_same_catalog(ours, theirs)
    assert_same_catalog(Catalog(tmp_path / "port"), JaxCatalog(tmp_path / "jax"))
    assert ours.cache_directory == tmp_path / "port"


def test_new_constructors_need_the_card_by_default(caches, table, tmp_path):
    """Without a card the file and random constructors raise for their
    default device instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    centers = caches["port"].get_centers()
    path = tmp_path / "unknown.fits"
    write_fits(path, table)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Catalog.from_file(None, path, patch_centers=centers, **FILE_COLUMNS)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Catalog.from_random(None, BoxRandoms(30, 60, -10, 10), 100, patch_centers=centers)
