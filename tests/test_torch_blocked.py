"""The port's blocked (out-of-core) measurement path.

Held against the port's own in-memory path and against the JAX package's
blocked path on the same seeded inputs (4k/6k/9k points, 12 patches, 4
bins, as ``tests/test_blocked.py``). Counts agree to ``rtol=1e-6,
atol=1e-3`` (the blocks' tiles equal the full catalog's per patch; the
device accumulation reduces to scales in float32 where the in-memory path
does so in float64), jackknife data and samples to 1e-6 / 1e-5. Paths that
feed the engine the same tiles in the same order (lazy vs in-memory
catalogs, store hits vs rebuilds, spilled vs resident blocks) agree
bitwise. The port runs its plain engine on the CPU (``device="cpu"``), the
JAX package its XLA engine with float lanes."""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from yet_another_wizz_tpu.catalog import Catalog as JaxCatalog
from yet_another_wizz_tpu.config import Configuration as JaxConfiguration
from yet_another_wizz_tpu.correlation.measurements import (
    crosscorrelate as jax_crosscorrelate,
)
from yet_another_wizz_tpu_torch.catalog import Catalog, LazyCatalog
from yet_another_wizz_tpu_torch.config import Configuration
from yet_another_wizz_tpu_torch.correlation import blocked
from yet_another_wizz_tpu_torch.correlation.measurements import (
    PatchLinkage,
    autocorrelate,
    autocorrelate_scalar,
    crosscorrelate,
    crosscorrelate_scalar,
)
from yet_another_wizz_tpu_torch.examples import generate_mock_data
from yet_another_wizz_tpu_torch.utils import tracing

SIZES = dict(num_reference=4000, num_unknown=6000, num_randoms=9000)
SEED = 21
NUM_PATCHES = 12
CONFIG = dict(rmin=500, rmax=3000, unit="kpc", zmin=0.15, zmax=1.0, num_bins=4)
CONFIG_B = dict(
    rmin=[100, 300, 500], rmax=[300, 500, 1000], unit="kpc", rweight=-1.0,
    resolution=32, zmin=0.15, zmax=1.0, num_bins=4,
)


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads: the blocked loop's prefetch workers run beside
    torch's thread pool, and at these shapes two threads are as fast as
    every core, while a full pool per test process stalls on a loaded
    machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mock():
    mock = generate_mock_data(**SIZES, seed=SEED)
    kappa = np.random.default_rng(SEED).normal(0.1, 0.3, SIZES["num_reference"])
    return mock, kappa


def make_catalogs(catalog_cls, mock, kappa, root=None, **kwargs):
    def cache(name):
        return None if root is None else root / name

    reference = catalog_cls.from_arrays(
        **mock["reference"], kappa=kappa, degrees=False, patch_num=NUM_PATCHES,
        cache_directory=cache("reference"), **kwargs,
    )
    centers = reference.get_centers()
    unknown, randoms = (
        catalog_cls.from_arrays(
            **mock[name], degrees=False, patch_centers=centers,
            cache_directory=cache(name), **kwargs,
        )
        for name in ("unknown", "randoms")
    )
    return reference, unknown, randoms


@pytest.fixture(scope="module")
def catalogs(mock):
    return make_catalogs(Catalog, *mock, device="cpu")


@pytest.fixture(scope="module")
def cache_root(mock, tmp_path_factory):
    root = tmp_path_factory.mktemp("blocked")
    make_catalogs(Catalog, *mock, root=root, device="cpu")
    return root


@pytest.fixture(scope="module")
def config():
    return Configuration.create(**CONFIG)


def assert_counts_close(actual, desired):
    assert_allclose(actual.counts.counts, desired.counts.counts, rtol=1e-6, atol=1e-3)


def assert_corrfunc_close(actual, desired, names):
    for name in names:
        assert_counts_close(getattr(actual, name), getattr(desired, name))
        for side in ("sum_weights1", "sum_weights2"):
            assert_allclose(
                getattr(getattr(actual, name).sum_weights, side),
                getattr(getattr(desired, name).sum_weights, side),
                rtol=1e-12,
            )
    sample, expected = actual.sample(), desired.sample()
    assert_allclose(sample.data, expected.data, rtol=1e-6)
    assert_allclose(sample.samples, expected.samples, rtol=1e-5)


def assert_corrfunc_equal(actual, desired, names):
    for name in names:
        assert_array_equal(
            getattr(actual, name).counts.counts, getattr(desired, name).counts.counts
        )


def cross(config, catalogs, **kwargs):
    reference, unknown, randoms = catalogs
    (corr,) = crosscorrelate(
        config, reference, unknown, ref_rand=randoms, device="cpu", **kwargs
    )
    return corr


@pytest.fixture(scope="module")
def cross_in_memory(catalogs, config):
    return cross(config, catalogs)


@pytest.mark.parametrize("max_resident", [4, 6, 24])
def test_cross_blocked_equals_in_memory(catalogs, config, cross_in_memory, max_resident):
    blocked_corr = cross(config, catalogs, max_resident_patches=max_resident)
    assert_corrfunc_close(blocked_corr, cross_in_memory, ["dd", "rd"])


def test_auto_blocked_equals_in_memory(catalogs, config):
    reference, _, randoms = catalogs
    (full,) = autocorrelate(config, reference, randoms, device="cpu")
    (blocked_corr,) = autocorrelate(
        config, reference, randoms, device="cpu", max_resident_patches=5
    )
    assert blocked_corr.get_estimator().name == "LS"
    assert_corrfunc_close(blocked_corr, full, ["dd", "dr", "rr"])


def test_direct_blocked_equals_in_memory(catalogs):
    config = Configuration.create(**CONFIG_B)
    links = PatchLinkage.from_catalogs(config, *catalogs)
    assert links.edges.direct is not None  # counted in direct mode
    full = crosscorrelate(
        config, catalogs[0], catalogs[1], ref_rand=catalogs[2], device="cpu"
    )
    blocked_corrs = crosscorrelate(
        config, catalogs[0], catalogs[1], ref_rand=catalogs[2], device="cpu",
        max_resident_patches=4,
    )
    assert len(blocked_corrs) == 3
    for blocked_corr, expected in zip(blocked_corrs, full):
        assert_corrfunc_close(blocked_corr, expected, ["dd", "rd"])


def test_scalar_blocked_equals_in_memory(catalogs, config):
    reference, unknown, randoms = catalogs
    (kn,) = crosscorrelate_scalar(
        config, reference, unknown, unk_rand=randoms, device="cpu"
    )
    (kn_blocked,) = crosscorrelate_scalar(
        config, reference, unknown, unk_rand=randoms, device="cpu",
        max_resident_patches=6,
    )
    (kk,) = autocorrelate_scalar(config, reference, device="cpu")
    (kk_blocked,) = autocorrelate_scalar(
        config, reference, device="cpu", max_resident_patches=6
    )
    for actual, expected in ((kn_blocked, kn), (kk_blocked, kk)):
        for name in ("dd", "dr"):
            ours, theirs = getattr(actual, name), getattr(expected, name)
            if theirs is None:
                continue
            for part in ("kappa_counts", "number_counts"):
                assert_allclose(
                    getattr(ours, part).counts, getattr(theirs, part).counts,
                    rtol=1e-6, atol=1e-3,
                )
        assert_allclose(actual.sample().data, expected.sample().data, rtol=1e-5, atol=1e-6)


def test_blocked_equals_jax_blocked(mock, catalogs, config, monkeypatch):
    monkeypatch.setenv("YAWT_LANE_ENCODING", "float")
    jax_catalogs = make_catalogs(JaxCatalog, *mock)
    (jax_corr,) = jax_crosscorrelate(
        JaxConfiguration.create(**CONFIG), *jax_catalogs[:2],
        ref_rand=jax_catalogs[2], backend="xla", mesh="single",
        max_resident_patches=6,
    )
    ours = cross(config, catalogs, max_resident_patches=6)
    assert_corrfunc_close(ours, jax_corr, ["dd", "rd"])


def test_device_accumulation_equals_host_scatter(catalogs, config, monkeypatch):
    device_mode = cross(config, catalogs, max_resident_patches=4)
    monkeypatch.setenv("YAWT_DEVICE_ACCUMULATE", "0")
    host_mode = cross(config, catalogs, max_resident_patches=4)
    # the two differ only in the float32 vs float64 scale reduction
    for name in ("dd", "rd"):
        assert_allclose(
            getattr(device_mode, name).counts.counts,
            getattr(host_mode, name).counts.counts, rtol=1e-6, atol=1e-4,
        )
    assert_allclose(device_mode.sample().data, host_mode.sample().data, rtol=1e-6)


def test_lazy_catalog_equals_catalog_bitwise(cache_root, config, cross_in_memory):
    names = ("reference", "unknown", "randoms")
    resident = cross(
        config, [Catalog(cache_root / n) for n in names], max_resident_patches=6
    )
    lazy = cross(
        config, [LazyCatalog(cache_root / n) for n in names], max_resident_patches=6
    )
    assert_corrfunc_equal(lazy, resident, ["dd", "rd"])
    assert_corrfunc_close(lazy, cross_in_memory, ["dd", "rd"])


def test_store_hit_equals_rebuild_bitwise(cache_root, config, monkeypatch):
    catalogs = [LazyCatalog(cache_root / n) for n in ("reference", "unknown", "randoms")]
    monkeypatch.setenv("YAWT_TILE_STORE", "0")
    rebuilt = cross(config, catalogs, max_resident_patches=8)
    monkeypatch.delenv("YAWT_TILE_STORE")
    cross(config, catalogs, max_resident_patches=8)  # fills the store

    def no_packing(*args, **kwargs):
        raise AssertionError("a block was packed despite the warm store")

    monkeypatch.setattr(blocked, "_build_block_tiles", no_packing)
    from_store = cross(config, catalogs, max_resident_patches=8)
    assert_corrfunc_equal(from_store, rebuilt, ["dd", "rd"])


def test_spill_only_equals_default(catalogs, config):
    default = cross(config, catalogs, max_resident_patches=4)
    with blocked.measurement_tile_cache(resident_tile_bytes=0) as cache:
        spilled = cross(config, catalogs, max_resident_patches=4)
        assert cache._resident_used == 0 and not cache._resident
        assert cache._paths and cache.hits > 0
    assert_corrfunc_equal(spilled, default, ["dd", "rd"])


def test_binding_resident_budget_equals_default(catalogs, config):
    """Under a resident budget of three blocks the cache evicts stale
    blocks across the count types, spills the rest to disk and reads them
    back; with both budgets 0 every block is rebuilt each sweep. The counts
    equal the default budget's bit for bit."""
    default = cross(config, catalogs, max_resident_patches=4)
    block = blocked._build_block_tiles(catalogs[1], None, "n", 0, 2, 512)
    budget = 3 * blocked._ColumnTileCache._device_nbytes(block)
    with blocked.measurement_tile_cache(resident_tile_bytes=budget) as cache:
        bound = cross(config, catalogs, max_resident_patches=4)
        assert cache.evictions > 0
        assert cache.spills > 0 and cache.spill_loads > 0
        assert 0 < cache._resident_used <= budget
    assert_corrfunc_equal(bound, default, ["dd", "rd"])
    with blocked.measurement_tile_cache(
        tile_cache_bytes=0, resident_tile_bytes=0
    ) as cache:
        rebuilt = cross(config, catalogs, max_resident_patches=4)
        assert cache.hits == 0 and cache.spills == cache.evictions == 0
        assert not cache._resident and not cache._paths
    assert_corrfunc_equal(rebuilt, default, ["dd", "rd"])


def test_prefetch_depth_and_phase_totals(catalogs, config, cross_in_memory, monkeypatch):
    """The blocked loop's phases are spans and its statistics counters."""
    tracing.reset()
    monkeypatch.setenv("YAWT_PREFETCH_BLOCKS", "3")
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]
    ) as profiler:
        deep = cross(config, catalogs, max_resident_patches=4)
    assert_corrfunc_close(deep, cross_in_memory, ["dd", "rd"])
    totals = tracing.counters
    assert totals["blocked.block_pairs"] > 0 and totals["engine.candidate_pairs"] > 0
    phases = tracing.span_totals(profiler)
    for key in ("rows", "cols", "pairs", "queue", "drain_wait", "drain_fetch",
                "drain_scatter", "preamble", "teardown"):
        assert phases[f"blocked.{key}"][1] >= 0.0
    # per block pair that runs, its count and its scatter are queued
    assert phases["blocked.queue"][0] == 2 * totals["blocked.block_pairs"]
    assert "blocked.upload_bytes" not in totals  # nothing crosses to a CPU device


def test_scatter_block_scales_equals_jax():
    """K2.3 in torch against the JAX package's jitted version, on the same
    arrays: slots scattered to their patch pairs, same-patch auto slots
    halved, and JAX's padding rows (code 0, the dump row P) dropped."""
    from yet_another_wizz_tpu.correlation.blocked import (
        _scatter_block_scales as jax_scatter,
    )

    rng = np.random.default_rng(5)
    num_slots, num_bins, num_edges, num_scales, num_patches = 37, 4, 6, 3, 9
    counts = np.cumsum(
        rng.uniform(0, 1e4, (num_slots, num_bins, num_edges)), axis=-1
    ).astype(np.float32)
    scale_map = (rng.uniform(size=(num_bins, num_edges - 1, num_scales)) < 0.6)
    scale_map = scale_map.astype(np.float32)
    flat = rng.choice(num_patches * num_patches, num_slots, replace=False)
    patch1, patch2 = np.divmod(flat, num_patches)
    factor = np.where(patch1 == patch2, 0.5, 1.0).astype(np.float32)
    accum = torch.zeros((num_scales, num_bins, num_patches, num_patches))
    blocked.scatter_block_scales(
        torch.from_numpy(counts), torch.from_numpy(scale_map),
        torch.from_numpy(patch1), torch.from_numpy(patch2),
        torch.from_numpy(factor), accum,
    )
    pad = 7
    idx = np.full((3, num_slots + pad), num_patches, dtype=np.int32)
    idx[2, num_slots:] = 0
    idx[0, :num_slots], idx[1, :num_slots] = patch1, patch2
    idx[2, :num_slots] = np.where(patch1 == patch2, 1, 2)
    padded = np.concatenate(
        [counts, np.full((pad, num_bins, num_edges), np.nan, np.float32)]
    )
    expected = np.asarray(jax_scatter(
        padded, scale_map, idx,
        np.zeros((num_scales, num_bins, num_patches + 1, num_patches + 1), np.float32),
    ))
    assert np.any(patch1 == patch2)
    assert_allclose(accum.numpy(), expected[:, :, :num_patches, :num_patches], rtol=1e-6)


@pytest.mark.parametrize("shape", ["cross", "auto"])
def test_block_pairs_write_each_patch_pair_once(catalogs, config, monkeypatch, shape):
    """Block pairs partition the patch pairs, and within one every slot is
    a distinct patch pair: each accumulator element is written once per
    count, so the device accumulation does not depend on the order of its
    adds."""
    seen = []
    original = blocked.scatter_block_scales

    def recording(counts, scale_map, patch1, patch2, factor, accum):
        seen.append(np.stack([patch1.numpy(), patch2.numpy()], axis=1))
        return original(counts, scale_map, patch1, patch2, factor, accum)

    monkeypatch.setattr(blocked, "scatter_block_scales", recording)
    reference, unknown, _ = catalogs
    links = PatchLinkage.from_catalogs(config, reference, unknown)
    other = () if shape == "auto" else (unknown,)
    links.count_pairs(reference, *other, device="cpu", max_resident_patches=4)
    pairs = np.concatenate(seen)
    assert len(seen) > 1
    assert len(np.unique(pairs, axis=0)) == len(pairs)
    expected = links.linkage.patch_pairs(auto=shape == "auto")
    assert len(pairs) <= len(expected)


def test_eviction_drops_device_lanes(catalogs, config):
    """A resident tile set evicted across counts releases its lanes."""
    binning = config.binning.binning
    reference = catalogs[0]
    cache = blocked._ColumnTileCache(None, 0, resident_bytes=1)
    first = blocked._build_block_tiles(reference, binning, "n", 0, 3, 512)
    second = blocked._build_block_tiles(reference, binning, "n", 3, 6, 512)
    cache._resident_bytes = cache._device_nbytes(first)
    token = cache.begin_count()
    cache.store(("a", 0), first)
    first.device_data("cpu")
    assert first.device_upload("cpu") is None and first._device_lanes
    cache.end_count(token)
    token = cache.begin_count()
    cache.store(("b", 0), second)  # needs the budget of the stale entry
    cache.end_count(token)
    assert list(cache._resident) == [("b", 0)]
    assert not first._device_lanes


def test_audit_and_mesh_still_raise(catalogs, config):
    """Blocked under a mesh gives the blocked single-device counts (a mesh
    that is not a ``Mesh`` raises); the audit runs blocked and gives the
    blocked counts of the in-memory audited measurement."""
    from yet_another_wizz_tpu_torch.parallel import default_mesh

    with pytest.raises(TypeError, match="Mesh"):
        cross(config, catalogs, max_resident_patches=4, mesh=object())
    single = cross(config, catalogs, max_resident_patches=4)
    sharded = cross(
        config, catalogs, max_resident_patches=4, mesh=default_mesh(3, "cpu"),
        data_sharding="ring",
    )
    assert_corrfunc_close(sharded, single, ("dd", "rd"))
    links = PatchLinkage.from_catalogs(config, *catalogs[:2])
    audited = blocked.count_pairs_blocked(
        links.edges, links.linkage, catalogs[0], catalogs[1],
        config.binning.binning, auto=False, binned2=False, device="cpu",
        audit=True, max_resident_patches=4,
    )
    (memory,) = links.count_pairs(catalogs[0], catalogs[1], device="cpu", audit=True)
    expected = memory.counts.counts
    assert_allclose(audited[0], expected, rtol=1e-6, atol=1e-6 * np.abs(expected).max())


def test_blocked_path_needs_the_card_by_default(catalogs, config):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    reference, unknown, randoms = catalogs
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        crosscorrelate(
            config, reference, unknown, ref_rand=randoms, max_resident_patches=4
        )
    links = PatchLinkage.from_catalogs(config, reference, unknown)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        blocked.count_pairs_blocked(
            links.edges, links.linkage, reference, unknown,
            config.binning.binning, auto=False, binned2=False,
        )
