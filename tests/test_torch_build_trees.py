"""``Catalog.build_trees``, ``LazyCatalog.build_trees`` and
``HandlesDataChunk.copy_chunk_info`` against the JAX package, on the CPU.

On the same arrays and patch centers, ``build_trees`` leaves the same tile
cache keys as the JAX package's: unbinned, binned without ``max_angle``
(``zmajor``), with a ``max_angle`` that picks the ``spatial`` and one that
picks the ``zmajor`` cross-correlation layout, and after ``force=True``. A
``crosscorrelate(device="cpu")`` after ``build_trees`` builds no tile set
and equals, bit for bit, the counts of catalogs that built their tiles on
demand. The lazy catalog raises as the JAX package's does, the
attribute-description copy equals the JAX package's, and ``build_trees``
without a card raises for its default device.
"""

from __future__ import annotations

import torch_threads  # noqa: F401  (one torch thread per test process)
import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from yet_another_wizz_tpu.catalog import Catalog as JaxCatalog
from yet_another_wizz_tpu.catalog import LazyCatalog as JaxLazyCatalog
from yet_another_wizz_tpu.datachunk import DataChunkInfo as JaxDataChunkInfo
from yet_another_wizz_tpu.datachunk import HandlesDataChunk as JaxHandlesDataChunk
from yet_another_wizz_tpu_torch.catalog import Catalog, LazyCatalog
from yet_another_wizz_tpu_torch.catalog import catalog as catalog_module
from yet_another_wizz_tpu_torch.config import Configuration
from yet_another_wizz_tpu_torch.correlation.measurements import (
    PatchLinkage,
    crosscorrelate,
)
from yet_another_wizz_tpu_torch.datachunk import DataChunkInfo, HandlesDataChunk
from yet_another_wizz_tpu_torch.examples import generate_mock_data
from yet_another_wizz_tpu_torch.ops.tiles import preferred_tile_layout

SIZES = dict(num_reference=2000, num_unknown=3000, num_randoms=4000)
NUM_PATCHES = 8
EDGES = np.linspace(0.15, 1.0, 5)
CONFIG = dict(rmin=500, rmax=3000, unit="kpc", zmin=0.15, zmax=1.0, num_bins=4)


@pytest.fixture(scope="module")
def mock():
    return generate_mock_data(**SIZES, seed=31)


@pytest.fixture(scope="module")
def centers(mock):
    reference = Catalog.from_arrays(
        **mock["reference"], degrees=False, patch_num=NUM_PATCHES, device="cpu"
    )
    return reference.get_centers().to_3d()


def catalogs(mock, centers):
    return [
        Catalog.from_arrays(**mock[name], degrees=False, patch_centers=centers, device="cpu")
        for name in ("reference", "unknown", "randoms")
    ]


@pytest.mark.parametrize(
    "binned, max_angle", [(False, None), (True, None), (True, 1e-4), (True, 0.3)],
    ids=["unbinned", "zmajor", "small angle", "large angle"],
)
def test_build_trees_leaves_the_jax_cache_keys(mock, centers, binned, max_angle):
    edges = EDGES if binned else None
    ours = Catalog.from_arrays(
        **mock["reference"], degrees=False, patch_centers=centers, device="cpu"
    )
    theirs = JaxCatalog.from_arrays(**mock["reference"], degrees=False, patch_centers=centers)
    ours.build_trees(edges, max_angle=max_angle, device="cpu")
    theirs.build_trees(edges, max_angle=max_angle)
    assert set(ours._tile_cache) == set(theirs._tile_cache)
    layouts = {key[4] for key in ours._tile_cache}
    if max_angle is not None:
        expected = preferred_tile_layout(ours, len(EDGES) - 1, max_angle, equal_bin_counting=False)
        assert layouts == {"zmajor", expected}
        assert expected == ("spatial" if max_angle < 0.01 else "zmajor")
    else:
        assert layouts == {"zmajor" if binned else "spatial"}
    # force drops what an earlier call built, in both packages
    ours.get_tiles(None)
    theirs.get_tiles(None)
    ours.build_trees(EDGES, force=True, device="cpu")
    theirs.build_trees(EDGES, force=True)
    assert set(ours._tile_cache) == set(theirs._tile_cache)
    assert {key[4] for key in ours._tile_cache} == {"zmajor"}


def test_measurement_after_build_trees_builds_nothing(mock, centers, monkeypatch):
    config = Configuration.create(**CONFIG)
    reference, unknown, randoms = catalogs(mock, centers)
    (expected,) = crosscorrelate(config, reference, unknown, ref_rand=randoms, device="cpu")

    reference, unknown, randoms = catalogs(mock, centers)
    max_angle = PatchLinkage.from_catalogs(config, reference, unknown, randoms).edges.max_angle
    edges = config.binning.binning.edges
    for catalog in (reference, randoms):
        catalog.build_trees(edges, max_angle=max_angle, device="cpu")
    unknown.build_trees(None, device="cpu")
    builds = []
    build = catalog_module.build_tile_set

    def counted(*args, **kwargs):
        builds.append(args[2])
        return build(*args, **kwargs)

    monkeypatch.setattr(catalog_module, "build_tile_set", counted)
    (warmed,) = crosscorrelate(config, reference, unknown, ref_rand=randoms, device="cpu")
    assert builds == []
    for name in ("dd", "rd"):
        assert_array_equal(
            getattr(warmed, name).counts.counts, getattr(expected, name).counts.counts
        )
        assert_array_equal(
            getattr(warmed, name).sum_weights.sum_weights1,
            getattr(expected, name).sum_weights.sum_weights1,
        )


def test_lazy_catalog_build_trees_raises_as_jax(mock, centers, tmp_path):
    Catalog.from_arrays(
        **mock["reference"], degrees=False, patch_centers=centers,
        cache_directory=tmp_path / "cache", device="cpu",
    )
    with pytest.raises(NotImplementedError) as ours:
        LazyCatalog(tmp_path / "cache").build_trees(EDGES)
    with pytest.raises(NotImplementedError) as theirs:
        JaxLazyCatalog(tmp_path / "cache").build_trees(EDGES)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("drop_patch_ids", [False, True])
def test_copy_chunk_info_equals_jax(drop_patch_ids):
    def holder(base, info_cls):
        obj = base()
        obj._chunk_info = info_cls(has_weights=True, has_redshifts=False,
                                   has_patch_ids=True, has_kappa=True)
        return obj

    ours = holder(HandlesDataChunk, DataChunkInfo)
    theirs = holder(JaxHandlesDataChunk, JaxDataChunkInfo)
    copy = ours.copy_chunk_info(drop_patch_ids=drop_patch_ids)
    jax_copy = theirs.copy_chunk_info(drop_patch_ids=drop_patch_ids)
    flags = ("has_weights", "has_redshifts", "has_patch_ids", "has_kappa")
    assert [getattr(copy, f) for f in flags] == [getattr(jax_copy, f) for f in flags]
    assert copy.has_patch_ids is not drop_patch_ids
    assert copy is not ours.attrs and ours.has_patch_ids  # the original is kept
    assert copy.to_bytes() == jax_copy.to_bytes()


def test_build_trees_needs_the_card_by_default(mock, centers):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    catalog = Catalog.from_arrays(
        **mock["unknown"], degrees=False, patch_centers=centers, device="cpu"
    )
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        catalog.build_trees(None)
    assert catalog._tile_cache == {}
