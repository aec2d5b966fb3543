"""The port's persistent packed-tile store: round trip, fingerprint, and
coexistence with the JAX package's store in one cache directory."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import numpy as np
import pytest
from numpy.testing import assert_array_equal

from yet_another_wizz_tpu.catalog import Catalog as JaxCatalog
from yet_another_wizz_tpu.catalog.tilestore import (
    PackedTileStore as JaxPackedTileStore,
)
from yet_another_wizz_tpu.correlation.blocked import (
    _build_block_tiles as jax_build_block_tiles,
)
from yet_another_wizz_tpu_torch.binning import Binning
from yet_another_wizz_tpu_torch.catalog import Catalog, LazyCatalog
from yet_another_wizz_tpu_torch.catalog.tilestore import (
    TILE_SET_ARRAYS,
    TILE_SET_SCALARS,
    PackedTileStore,
)
from yet_another_wizz_tpu_torch.correlation.blocked import _build_block_tiles
from yet_another_wizz_tpu_torch.examples import generate_mock_data

NUM_PATCHES = 12
BLOCK = 3


@pytest.fixture(scope="module")
def cached(tmp_path_factory):
    mock = generate_mock_data(
        num_reference=4000, num_unknown=10, num_randoms=10, seed=21
    )
    directory = tmp_path_factory.mktemp("store") / "reference"
    Catalog.from_arrays(
        **mock["reference"], degrees=False, patch_num=NUM_PATCHES,
        cache_directory=directory, device="cpu",
    )
    return directory


@pytest.fixture(scope="module")
def binning():
    return Binning(np.linspace(0.15, 1.0, 5))


def open_store(catalog, binning, **changes):
    args = dict(binning=binning, mode="n", layout="zmajor", block=BLOCK, tile_size=512)
    return PackedTileStore.open(catalog, **{**args, **changes})


def block_tiles(catalog, binning, lo):
    return _build_block_tiles(
        catalog, binning, "n", lo, lo + BLOCK, 512, layout="zmajor"
    )


def test_round_trip(cached, binning, tmp_path):
    catalog = Catalog(cached)
    store = open_store(catalog, binning)
    tiles = block_tiles(catalog, binning, 3)
    assert store.load(3) is None
    store.save(3, tiles)
    loaded = store.load(3)
    assert (store.hits, store.misses) == (1, 1)
    for name in TILE_SET_ARRAYS + TILE_SET_SCALARS:
        assert_array_equal(getattr(loaded, name), getattr(tiles, name))
        assert np.asarray(getattr(loaded, name)).dtype == np.asarray(
            getattr(tiles, name)
        ).dtype
    assert loaded.sum_kappa is None


def test_catalog_and_lazy_catalog_share_a_store(cached, binning):
    assert (
        open_store(Catalog(cached), binning)._dir
        == open_store(LazyCatalog(cached), binning)._dir
    )


@pytest.mark.parametrize(
    "change",
    [
        dict(binning=None), dict(mode="k"), dict(layout="spatial"),
        dict(block=BLOCK + 1), dict(tile_size=256),
    ],
    ids=["binning", "mode", "layout", "block", "tile_size"],
)
def test_fingerprint_changes_with_the_tiling(cached, binning, change):
    catalog = LazyCatalog(cached)
    changed = open_store(catalog, **{"binning": binning, **change})
    assert open_store(catalog, binning)._dir != changed._dir


def test_other_binning_edges_change_the_fingerprint(cached, binning):
    catalog = LazyCatalog(cached)
    other = Binning(np.linspace(0.15, 1.0, 6))
    assert open_store(catalog, binning)._dir != open_store(catalog, other)._dir


def test_store_needs_a_cache_and_can_be_disabled(cached, binning, monkeypatch):
    mock = generate_mock_data(num_reference=500, num_unknown=1, num_randoms=1, seed=2)
    in_memory = Catalog.from_arrays(**mock["reference"], degrees=False, patch_num=4, device="cpu")
    assert open_store(in_memory, binning) is None
    monkeypatch.setenv("YAWT_TILE_STORE", "0")
    assert open_store(Catalog(cached), binning) is None


def test_torn_file_is_a_miss_and_removed(cached, binning):
    store = open_store(LazyCatalog(cached), binning)
    path = store._path(6)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"PK\x03\x04 torn")
    assert store.load(6) is None
    assert not path.exists()


def test_jax_store_is_a_miss(cached, binning, monkeypatch):
    """The JAX package's store in the same cache directory is never read:
    its blocks hash to other directories, which stay untouched."""
    from yet_another_wizz_tpu.binning import Binning as JaxBinning

    monkeypatch.setenv("YAWT_LANE_ENCODING", "float")
    jax_catalog = JaxCatalog(cached)
    jax_binning = JaxBinning(binning.edges)
    jax_store = JaxPackedTileStore.open(
        jax_catalog, jax_binning, "n", "zmajor", BLOCK, 512
    )
    jax_tiles = jax_build_block_tiles(
        jax_catalog, jax_binning, "n", 9, 9 + BLOCK, 512, layout="zmajor"
    )
    jax_store.save(9, jax_tiles)
    jax_file = jax_store._path(9)
    assert jax_file.exists()

    store = open_store(LazyCatalog(cached), binning)
    assert store._dir != jax_store._dir
    assert store.load(9) is None
    assert jax_file.exists()
    store.save(9, block_tiles(Catalog(cached), binning, 9))
    assert store.load(9) is not None
    assert jax_store.load(9) is not None  # and the JAX package still reads its own
