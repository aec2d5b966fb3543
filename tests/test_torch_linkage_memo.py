"""What the patch linkage derives from immutable inputs, derived once.

Every constructor of the in-memory ``Catalog`` stores its per-patch counts,
so ``get_num_records`` makes no pass over the rows. The angular edge tables
of a configuration are kept in a small memo in ``correlation/measurements``,
keyed on the values that determine them: a configuration rebuilt from the
same values finds them, any changed value misses, a cosmology of a user's
class builds them on every call, and a shared entry rejects writes. A
repeated measurement gives the counts bitwise of one with the memo emptied.
"""

from __future__ import annotations

import torch_threads  # noqa: F401  (one torch thread per test process)
import sys
import threading

import numpy as np
import pytest
from numpy.testing import assert_array_equal
from torch_cli_cases import write_fits

from yet_another_wizz_tpu_torch.catalog import Catalog
from yet_another_wizz_tpu_torch.config import Configuration
from yet_another_wizz_tpu_torch.correlation import measurements
from yet_another_wizz_tpu_torch.correlation.measurements import (
    PatchLinkage,
    autocorrelate,
    crosscorrelate,
)
from yet_another_wizz_tpu_torch.cosmology import (
    CustomCosmology,
    FLRWCosmology,
    Planck15,
)
from yet_another_wizz_tpu_torch.examples import generate_mock_data
from yet_another_wizz_tpu_torch.ops.thresholds import build_angular_edges
from yet_another_wizz_tpu_torch.utils import tracing

SIZES = dict(num_reference=1500, num_unknown=2500, num_randoms=4000)
SEED = 11
NUM_PATCHES = 6
BASE = dict(
    rmin=[100, 300], rmax=[300, 1000], unit="kpc", rweight=-1.0,
    resolution=32, zmin=0.15, zmax=1.0, num_bins=4,
)
"""A weighted configuration with many union edges: it builds the
direct-mode tables too."""

CONFIGS = {
    "single": dict(rmin=100, rmax=1000, unit="kpc", zmin=0.15, zmax=1.0, num_bins=5),
    "weighted": BASE,
    "cumulative": dict(BASE, counting="cumulative"),
    "arcmin": dict(rmin=[0.5, 1.0], rmax=[2.0, 4.0], unit="arcmin", zmin=0.1, zmax=0.9, num_bins=3),
    "comoving": dict(rmin=0.2, rmax=2.0, unit="Mpc/h", rweight=-0.8, resolution=20, zmin=0.2, zmax=1.2, num_bins=6),
}

CHANGES = {
    "scales": dict(rmin=[110, 300]),
    "unit": dict(rmin=[0.1, 0.3], rmax=[0.3, 1.0], unit="Mpc"),
    "bins": dict(num_bins=5),
    "bin_range": dict(zmax=1.1),
    "cosmology": dict(cosmology=FLRWCosmology(H0=70.0, Om0=0.3)),
    "hubble": dict(cosmology=FLRWCosmology(H0=70.0, Om0=0.3089)),
    "rweight": dict(rweight=-0.5),
    "unweighted": dict(rweight=None),
    "resolution": dict(resolution=33),
    "counting": dict(counting="cumulative"),
}

CHANGED_FROM = {"hubble": dict(cosmology=FLRWCosmology(H0=67.74, Om0=0.3089))}
"""Where a change needs another base: without radiation, ``Ode0`` does not
follow ``H0``, so the two cosmologies differ in ``H0`` alone."""

ARRAYS = [
    ("chord2_table",), ("edges",), ("scale_maps",),
    ("direct", "chord2_table"), ("direct", "edges"),
    ("direct", "scale_maps"), ("direct", "gtable"),
]


class WrappedPlanck(CustomCosmology):
    """A user's cosmology class: its values cannot be read."""

    def comoving_distance(self, z):
        return Planck15.comoving_distance(z)

    def angular_diameter_distance(self, z):
        return Planck15.angular_diameter_distance(z)


@pytest.fixture(autouse=True)
def empty_memo():
    measurements._edges_memo.clear()
    yield
    measurements._edges_memo.clear()


def counted(before: dict) -> dict:
    """The edge memo's hits and misses since ``before``."""
    now = tracing.snapshot()
    return {
        kind: now.get(f"cache.{kind}.edges", 0) - before.get(f"cache.{kind}.edges", 0)
        for kind in ("hit", "miss")
    }


def fresh(config) -> object:
    return build_angular_edges(
        config.scales.scales,
        config.binning.binning.mids,
        config.cosmology,
        weight_scale=config.scales.rweight,
        weight_res=config.scales.resolution,
        counting=config.scales.counting,
    )


def assert_same_tables(actual, expected):
    for table, other in ((actual, expected), (actual.direct, expected.direct)):
        if other is None:
            assert table is None
            continue
        for name in ("chord2_table", "edges", "scale_maps", "gtable"):
            if hasattr(other, name):
                a, b = getattr(table, name), getattr(other, name)
                assert a.dtype == b.dtype
                assert_array_equal(a, b, strict=True)
    assert actual.max_angle == expected.max_angle
    if expected.direct is not None:
        for name in ("num_sub", "num_below", "num_above"):
            assert getattr(actual.direct, name) == getattr(expected.direct, name)


# -- per-patch counts kept on the catalog -----------------------------------


@pytest.fixture(scope="module")
def mock():
    return generate_mock_data(**SIZES, seed=SEED)


@pytest.fixture(scope="module")
def reference(mock):
    return Catalog.from_arrays(
        **mock["reference"], degrees=False, patch_num=NUM_PATCHES, device="cpu"
    )


def build_catalog(how, mock, reference, tmp_path):
    unknown = mock["unknown"]
    if how == "patch_num":
        return reference
    if how == "patch_centers":
        return Catalog.from_arrays(
            **unknown, degrees=False, patch_centers=reference.get_centers(),
            device="cpu",
        )
    if how == "patch_ids":
        ids = np.arange(len(unknown["ra"])) % NUM_PATCHES
        return Catalog.from_arrays(
            **unknown, degrees=False, patch_ids=ids, device="cpu"
        )
    if how == "cache":
        Catalog.from_arrays(
            **unknown, degrees=False, patch_centers=reference.get_centers(),
            cache_directory=tmp_path / "cache", device="cpu",
        )
        return Catalog(tmp_path / "cache")
    path = tmp_path / "unknown.fits"
    write_fits(path, dict(
        RA=np.rad2deg(unknown["ra"]), DEC=np.rad2deg(unknown["dec"]),
        W=unknown["weights"], Z=unknown["redshifts"],
    ))
    return Catalog.from_file(
        tmp_path / "streamed", path, ra_name="RA", dec_name="DEC",
        weight_name="W", redshift_name="Z",
        patch_centers=reference.get_centers(), chunksize=700,
        streaming=True, device="cpu",
    )


@pytest.mark.parametrize(
    "how", ["patch_centers", "patch_num", "patch_ids", "cache", "streaming"]
)
def test_every_constructor_keeps_the_patch_counts(how, mock, reference, tmp_path, monkeypatch):
    catalog = build_catalog(how, mock, reference, tmp_path)
    expected = np.bincount(catalog.patch_ids, minlength=catalog.num_patches)
    calls = []
    real = np.bincount
    monkeypatch.setattr(np, "bincount", lambda *a, **k: calls.append(a) or real(*a, **k))
    counts = catalog.get_num_records()
    sums = catalog.get_sum_weights() if not catalog.has_weights else None
    monkeypatch.undo()
    assert calls == []  # no pass over the rows
    assert counts == tuple(int(c) for c in expected)
    assert all(type(c) is int for c in counts)
    if sums is not None:
        assert sums == tuple(float(c) for c in expected)


# -- the edge-table memo ----------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_a_hit_returns_the_tables_a_fresh_build_gives(name):
    config = Configuration.create(**CONFIGS[name])
    before = tracing.snapshot()
    first = measurements._angular_edges(config)
    second = measurements._angular_edges(config)
    assert second is first
    assert counted(before) == {"hit": 1, "miss": 1}
    assert_same_tables(second, fresh(config))


@pytest.mark.parametrize("change", list(CHANGES))
def test_any_changed_value_misses(change):
    base = Configuration.create(**dict(BASE, **CHANGED_FROM.get(change, {})))
    changed = Configuration.create(**dict(BASE, **CHANGES[change]))
    first = measurements._angular_edges(base)
    before = tracing.snapshot()
    edges = measurements._angular_edges(changed)
    assert counted(before) == {"hit": 0, "miss": 1}
    assert edges is not first
    assert_same_tables(edges, fresh(changed))
    assert measurements._angular_edges(base) is first


@pytest.mark.parametrize("via", ["dict", "yaml"])
def test_a_configuration_rebuilt_from_its_values_hits(via, tmp_path):
    config = Configuration.create(**BASE)
    if via == "dict":
        rebuilt = Configuration.from_dict(config.to_dict())
    else:
        config.to_file(tmp_path / "config.yml")
        rebuilt = Configuration.from_file(tmp_path / "config.yml")
    assert rebuilt is not config and rebuilt == config
    first = measurements._angular_edges(config)
    before = tracing.snapshot()
    assert measurements._angular_edges(rebuilt) is first
    assert counted(before) == {"hit": 1, "miss": 0}


@pytest.mark.parametrize("path", ARRAYS, ids=".".join)
def test_a_shared_entry_rejects_writes(path):
    edges = measurements._angular_edges(Configuration.create(**BASE))
    array = edges
    for name in path:
        array = getattr(array, name)
    assert not array.flags.writeable
    with pytest.raises(ValueError, match="read-only"):
        array[...] = 0


def test_the_memo_stays_within_its_bound():
    size = measurements._EDGES_MEMO_SIZE
    configs = [
        Configuration.create(**dict(BASE, rmax=[300, 1000 + i])) for i in range(2 * size)
    ]
    for config in configs:
        measurements._angular_edges(config)
        assert len(measurements._edges_memo) <= size
    before = tracing.snapshot()
    for config in configs[size:]:  # the newest are kept
        measurements._angular_edges(config)
    assert counted(before) == {"hit": size, "miss": 0}
    before = tracing.snapshot()
    measurements._angular_edges(configs[0])  # the oldest went first
    assert counted(before) == {"hit": 0, "miss": 1}
    assert len(measurements._edges_memo) == size


def test_threads_share_the_memo_without_losing_a_count():
    configs = [
        Configuration.create(**dict(BASE, rmax=[300, 1000 + i]))
        for i in range(measurements._EDGES_MEMO_SIZE + 2)
    ]
    expected = [fresh(config) for config in configs]
    calls, results, errors = 20, {}, []

    def work(worker):
        try:
            for i in range(calls):
                index = (worker + i) % len(configs)
                results[worker, i] = (index, measurements._angular_edges(configs[index]))
        except Exception as error:  # reported by the main thread
            errors.append(error)

    before = tracing.snapshot()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(w,)) for w in range(16)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(thread.is_alive() for thread in threads)
    assert errors == []
    assert len(results) == 16 * calls
    assert sum(counted(before).values()) == 16 * calls
    assert len(measurements._edges_memo) <= measurements._EDGES_MEMO_SIZE
    for index, edges in results.values():
        assert_same_tables(edges, expected[index])


@pytest.mark.parametrize("cosmology", ["custom", "flrw_subclass"])
def test_a_cosmology_without_a_value_key_builds_every_time(cosmology):
    if cosmology == "custom":
        cosmo = WrappedPlanck()
    else:
        cosmo = type("MyFLRW", (FLRWCosmology,), {})(H0=67.74, Om0=0.3089)
    config = Configuration.create(**dict(BASE, cosmology=cosmo))
    before = tracing.snapshot()
    first = measurements._angular_edges(config)
    second = measurements._angular_edges(config)
    assert counted(before) == {"hit": 0, "miss": 2}
    assert second is not first
    assert len(measurements._edges_memo) == 0
    assert_same_tables(second, fresh(config))
    if cosmology == "custom":  # the same distances as the default's
        assert_same_tables(second, fresh(Configuration.create(**BASE)))


def test_the_linkage_takes_its_tables_from_the_memo(mock, reference):
    config = Configuration.create(**BASE)
    unknown = Catalog.from_arrays(
        **mock["unknown"], degrees=False, patch_centers=reference.get_centers(),
        device="cpu",
    )
    before = tracing.snapshot()
    cross = PatchLinkage.from_catalogs(config, reference, unknown)
    auto = PatchLinkage.from_catalogs(Configuration.from_dict(config.to_dict()), reference)
    assert counted(before) == {"hit": 1, "miss": 1}
    assert auto.edges is cross.edges
    assert_array_equal(auto.linkage.linked, cross.linkage.linked)


# -- the same work ----------------------------------------------------------


def measure(config, catalogs) -> list:
    reference, unknown, randoms = catalogs
    cross = crosscorrelate(config, reference, unknown, ref_rand=randoms, device="cpu")
    auto = autocorrelate(config, reference, randoms, device="cpu")
    arrays = []
    for corrfunc in [*cross, *auto]:
        for name in ("dd", "dr", "rd", "rr"):
            counts = getattr(corrfunc, name)
            if counts is not None:
                arrays += [
                    counts.counts.counts,
                    counts.sum_weights.sum_weights1,
                    counts.sum_weights.sum_weights2,
                ]
    return arrays


def test_repeated_measurements_count_the_same_bits(mock, reference):
    centers = reference.get_centers()
    catalogs = (reference,) + tuple(
        Catalog.from_arrays(**mock[name], degrees=False, patch_centers=centers, device="cpu")
        for name in ("unknown", "randoms")
    )
    config = Configuration.create(**BASE)
    before = tracing.snapshot()
    first = measure(config, catalogs)
    second = measure(config, catalogs)
    assert counted(before) == {"hit": 3, "miss": 1}
    measurements._edges_memo.clear()
    emptied = measure(Configuration.create(**BASE), catalogs)
    for runs in zip(first, second, emptied):
        assert_array_equal(runs[0], runs[1], strict=True)
        assert_array_equal(runs[0], runs[2], strict=True)
