"""The port's sharded pair counting and process helpers against the JAX
package's ``parallel`` layer, on the CPU (modelled on
``tests/test_parallel.py``).

Inputs are built with numpy from a seed through the JAX package and
converted with :mod:`yet_another_wizz_tpu_torch.interop`, so both packages
see the same tile lanes and pair lists. The port's meshes here are CPU
entries (``default_mesh(n, "cpu")``), its counterpart of the JAX package's
eight virtual CPU devices (``tests/conftest.py``); every shard runs the
plain PyTorch versions of the kernels. Counts agree with the JAX package's
sharded XLA counts and with the port's single-device counts within
``rtol=1e-6`` (``atol=1e-6 * max|ref|``; direct mode 1e-5): the chord
arithmetic is the same, the float32 summation order is not.
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from test_engine import patch_geometry, random_cap_catalog, simple_patches
from yet_another_wizz_tpu.catalog import Catalog as JaxCatalog
from yet_another_wizz_tpu.config import Configuration as JaxConfiguration
from yet_another_wizz_tpu.correlation import measurements as jax_measurements
from yet_another_wizz_tpu.ops.linkage import build_linkage, build_tile_pairs
from yet_another_wizz_tpu.ops.tiles import build_tile_set as jax_build_tile_set
from yet_another_wizz_tpu.parallel import (
    count_pairs_sharded as jax_count_pairs_sharded,
)
from yet_another_wizz_tpu.parallel import default_mesh as jax_default_mesh
from yet_another_wizz_tpu_torch import interop
from yet_another_wizz_tpu_torch.catalog import Catalog
from yet_another_wizz_tpu_torch.config import Configuration
from yet_another_wizz_tpu_torch.correlation import measurements
from yet_another_wizz_tpu_torch.examples import generate_mock_data
from yet_another_wizz_tpu_torch.ops.linkage import TilePairs
from yet_another_wizz_tpu_torch.ops.paircount import count_pairs_tiles
from yet_another_wizz_tpu_torch.ops.tiles import shard_bounds
from yet_another_wizz_tpu_torch.parallel import (
    Mesh,
    auto_mesh,
    count_pairs_sharded,
    default_mesh,
    distributed,
    sharded,
)

LAYOUTS = ["replicated", "columns", "ring"]
TILESET_FIELDS = (
    "lane_data", "tile_patch", "tile_center", "tile_radius",
    "patch_tile_start", "patch_tile_stop", "sum_weights", "tile_zmin",
    "tile_zmax", "num_bins", "num_points",
)
CONFIG = dict(rmin=500, rmax=3000, unit="kpc", zmin=0.15, zmax=1.0, num_bins=4)
CONFIG_B = dict(
    rmin=[100, 300, 500], rmax=[300, 500, 1000], unit="kpc", rweight=-1.0,
    resolution=32, zmin=0.15, zmax=1.0, num_bins=4,
)


@pytest.fixture(autouse=True)
def float_lanes(monkeypatch):
    """The JAX engines upload float lanes, like the port."""
    monkeypatch.setenv("YAWT_LANE_ENCODING", "float")
    monkeypatch.delenv("YAWT_NUM_DEVICES", raising=False)


def assert_counts_close(actual, desired, rtol=1e-6):
    desired = np.asarray(desired)
    assert_allclose(actual, desired, rtol=rtol, atol=rtol * np.abs(desired).max())


def convert_tiles(jax_tiles):
    return interop.tileset_from_arrays(
        **{name: getattr(jax_tiles, name) for name in TILESET_FIELDS}
    )


def convert_pairs(jax_pairs):
    return interop.tilepairs_from_arrays(
        jax_pairs.tile1, jax_pairs.tile2, jax_pairs.slot, jax_pairs.slot_patches
    )


def make_problem(seed, *, n1, n2, num_bins, num_patches, auto=False):
    """The JAX package's tile sets and pair list (``tests/test_parallel.py``
    sizes), and the port's conversions of them."""
    rng = np.random.default_rng(seed)
    xyz1, w1, z1 = random_cap_catalog(rng, n1, num_bins)
    patch1 = simple_patches(xyz1, num_patches, np.random.default_rng(3))
    ts1 = jax_build_tile_set(
        xyz1, patch1, num_patches, weights=w1, zbins=z1, num_bins=num_bins,
        tile_size=64,
    )
    if auto:
        ts2 = ts1
    else:
        xyz2, w2, _ = random_cap_catalog(rng, n2, num_bins)
        patch2 = simple_patches(xyz2, num_patches, np.random.default_rng(3))
        ts2 = jax_build_tile_set(xyz2, patch2, num_patches, weights=w2, tile_size=64)
    edges = np.deg2rad(np.tile((0.2, 1.0), (num_bins, 1)))
    chord2 = ((2 * np.sin(edges / 2)) ** 2).astype(np.float32)
    centers, radii = patch_geometry(xyz1, patch1, num_patches)
    linkage = build_linkage(centers, radii, edges.max() * 1.000001)
    pairs = build_tile_pairs(ts1, ts2, linkage, auto=auto)
    port = (convert_tiles(ts1), convert_tiles(ts2), convert_pairs(pairs), chord2)
    if auto:
        port = (port[0], port[0], port[2], chord2)
    return (ts1, ts2, pairs, chord2), port


@pytest.fixture(scope="module")
def problem():
    return make_problem(12345, n1=3000, n2=4000, num_bins=3, num_patches=5)


@pytest.mark.parametrize("data_sharding", LAYOUTS)
def test_sharded_matches_jax_and_single_device(problem, data_sharding):
    jax_inputs, (ts1, ts2, pairs, chord2) = problem
    single = count_pairs_tiles(ts1, ts2, pairs, chord2, device="cpu", mesh="single")
    for num_shards in (2, 8):
        ours = count_pairs_sharded(
            ts1, ts2, pairs, chord2, mesh=default_mesh(num_shards, "cpu"),
            data_sharding=data_sharding,
        )
        theirs = jax_count_pairs_sharded(
            *jax_inputs, mesh=jax_default_mesh(num_shards),
            data_sharding=data_sharding, engine="xla",
        )
        assert ours.shape == single.shape and ours.dtype == np.float64
        assert_counts_close(ours, theirs)
        assert_counts_close(ours, single)
        again = count_pairs_sharded(
            ts1, ts2, pairs, chord2, mesh=default_mesh(num_shards, "cpu"),
            data_sharding=data_sharding,
        )
        assert_array_equal(again, ours)


def test_ring_binned_columns_against_jax():
    """Ring rotation with a binned column catalog (autocorrelation-style
    counting) and mesh sizes that do not divide the tile count."""
    jax_inputs, (ts, _, pairs, chord2) = make_problem(
        4242, n1=2500, n2=0, num_bins=2, num_patches=4, auto=True
    )
    assert ts.binned
    single = count_pairs_tiles(ts, ts, pairs, chord2, device="cpu", mesh="single")
    for num_shards in (3, 8):
        ours = count_pairs_sharded(
            ts, ts, pairs, chord2, mesh=default_mesh(num_shards, "cpu"),
            data_sharding="ring",
        )
        theirs = jax_count_pairs_sharded(
            *jax_inputs, mesh=jax_default_mesh(num_shards), data_sharding="ring",
            engine="xla",
        )
        assert_counts_close(ours, theirs)
        assert_counts_close(ours, single)


@pytest.fixture(scope="module")
def packages():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("YAWT_LANE_ENCODING", "float")
        mock = generate_mock_data(
            num_reference=1500, num_unknown=2500, num_randoms=5000, seed=11
        )

        def make(catalog_cls, **kwargs):
            ref = catalog_cls.from_arrays(
                **mock["reference"], degrees=False, patch_num=5, **kwargs
            )
            centers = ref.get_centers()
            return ref, *(
                catalog_cls.from_arrays(
                    **mock[name], degrees=False, patch_centers=centers, **kwargs
                )
                for name in ("unknown", "randoms")
            )

        return dict(port=make(Catalog, device="cpu"), jax=make(JaxCatalog))


def test_direct_mode_sharded(packages):
    """Direct separation-weighted counting (config B) sharded: every layout
    equals the single-device direct counts within 1e-5."""
    reference, unknown, _ = packages["port"]
    links = measurements.PatchLinkage.from_catalogs(
        Configuration.create(**CONFIG_B), reference, unknown
    )
    table, _, direct, _ = links.engine_table()
    assert direct is not None
    tiles1, tiles2, pairs = links._build_engine_inputs(reference, unknown)
    single = count_pairs_tiles(
        tiles1, tiles2, pairs, table, device="cpu", mesh="single", direct=direct
    )
    for data_sharding in LAYOUTS:
        ours = count_pairs_sharded(
            tiles1, tiles2, pairs, table, mesh=default_mesh(4, "cpu"),
            data_sharding=data_sharding, direct=direct,
        )
        assert_counts_close(ours, single, rtol=1e-5)


MEASUREMENTS = {
    "cross columns": dict(kind="cross", data_sharding="columns"),
    "cross ring audited": dict(kind="cross", data_sharding="ring", audit=True),
    "cross ring blocked": dict(
        kind="cross", data_sharding="ring", max_resident_patches=4, shards=4
    ),
    "auto ring": dict(kind="auto", data_sharding="ring"),
}


@pytest.mark.parametrize("case", list(MEASUREMENTS))
def test_measurements_with_mesh_match_jax(packages, case):
    """``crosscorrelate`` / ``autocorrelate`` with a mesh against the JAX
    package's with a mesh of as many devices (``tests/test_parallel.py::
    test_mesh_through_measurement_api``, ``test_mesh_with_blocked_mode``),
    audited and blocked too."""
    kwargs = dict(MEASUREMENTS[case])
    kind = kwargs.pop("kind")
    shards = kwargs.pop("shards", 8)
    port, theirs_catalogs = packages["port"], packages["jax"]
    names = ("dd", "rd") if kind == "cross" else ("dd", "dr", "rr")

    def run(module, config_cls, catalogs, mesh, **extra):
        config = config_cls.create(**CONFIG)
        if kind == "cross":
            (corr,) = module.crosscorrelate(
                config, catalogs[0], catalogs[1], ref_rand=catalogs[2],
                mesh=mesh, **kwargs, **extra,
            )
        else:
            (corr,) = module.autocorrelate(
                config, catalogs[0], catalogs[2], mesh=mesh, **kwargs, **extra
            )
        return corr

    ours = run(
        measurements, Configuration, port, default_mesh(shards, "cpu"), device="cpu"
    )
    theirs = run(
        jax_measurements, JaxConfiguration, theirs_catalogs,
        jax_default_mesh(shards), backend="xla",
    )
    for name in names:
        assert_counts_close(
            getattr(ours, name).counts.counts, getattr(theirs, name).counts.counts
        )
    assert_allclose(ours.sample().data, theirs.sample().data, rtol=1e-5)


def test_empty_pair_list_result_shape(problem):
    """An empty pair list gives the single-device result shape, with the
    edge axis of the counting columns only in direct mode."""
    from yet_another_wizz_tpu_torch.ops.gweight import num_param_cols

    _, (ts1, ts2, _, chord2) = problem
    empty = TilePairs(
        tile1=np.zeros(0, np.int32), tile2=np.zeros(0, np.int32),
        slot=np.zeros(0, np.int32), slot_patches=np.array([[0, 0], [1, 1]]),
    )
    mesh = default_mesh(2, "cpu")
    out = count_pairs_sharded(ts1, ts2, empty, chord2, mesh=mesh)
    single = count_pairs_tiles(ts1, ts2, empty, chord2, device="cpu", mesh="single")
    assert out.shape == single.shape == (2, *chord2.shape)
    assert not out.any()
    direct = (chord2.shape[1], 1, 1)
    combined = np.concatenate(
        [chord2, np.zeros((chord2.shape[0], num_param_cols(1, 1)), np.float32)],
        axis=1,
    )
    out = count_pairs_sharded(ts1, ts2, empty, combined, mesh=mesh, direct=direct)
    assert out.shape == (2, *chord2.shape)


@pytest.mark.parametrize("data_sharding", LAYOUTS)
def test_partition_is_balanced_and_slot_sorted(problem, data_sharding):
    """Every pair lands in exactly one step of one shard, each sub-list is
    slot-sorted with local tile indices inside its lanes, every shard owns
    tiles (the logical split, not a bucketed one), and the plan is cached
    on the pair list."""
    _, (ts1, ts2, pairs, _) = problem
    num_shards = 8
    assert ts2.num_tiles >= num_shards
    bounds = [shard_bounds(ts2.num_tiles, num_shards, d) for d in range(num_shards)]
    assert all(hi > lo for lo, hi in bounds)
    assert bounds[0][0] == 0 and bounds[-1][1] == ts2.num_tiles
    plan = sharded._shard_plan(pairs, ts1, ts2, num_shards, data_sharding)
    assert sharded._shard_plan(pairs, ts1, ts2, num_shards, data_sharding) is plan
    seen = []
    for shard, steps in enumerate(plan):
        assert steps, f"shard {shard} counts nothing"
        for row, sub in steps:
            assert np.all(np.diff(sub.slot) >= 0)
            lo2, hi2 = (0, ts2.num_tiles) if data_sharding == "replicated" else bounds[shard]
            assert np.all(sub.tile2 < hi2 - lo2) and np.all(sub.tile2 >= 0)
            lo1 = 0
            if row is not None:
                lo1, hi1 = shard_bounds(ts1.num_tiles, num_shards, row)
                assert np.all(sub.tile1 < hi1 - lo1)
            seen += list(zip(sub.tile1 + lo1, sub.tile2 + lo2, sub.slot))
    expected = list(zip(pairs.tile1, pairs.tile2, pairs.slot))
    assert sorted(seen) == sorted(expected)


def test_shard_uploads_are_cached_and_dropped(problem):
    _, (_, ts2, _, _) = problem
    whole = ts2.device_data("cpu")
    part = ts2.device_data("cpu", shard=(4, 1))
    lo, hi = shard_bounds(ts2.num_tiles, 4, 1)
    assert torch.equal(part, whole[lo:hi])
    assert ts2.device_data("cpu", shard=(4, 1)) is part
    ts2.drop_device_data()
    assert not ts2._device_lanes


def test_plain_engine_backend_and_errors(problem):
    _, (ts1, ts2, pairs, chord2) = problem
    mesh = default_mesh(3, "cpu")
    kernels = count_pairs_sharded(ts1, ts2, pairs, chord2, mesh=mesh)
    plain = count_pairs_sharded(ts1, ts2, pairs, chord2, mesh=mesh, backend="torch")
    assert_counts_close(plain, kernels)
    with pytest.raises(ValueError, match="data_sharding"):
        count_pairs_sharded(ts1, ts2, pairs, chord2, mesh=mesh, data_sharding="rows")
    with pytest.raises(ValueError, match="needs a mesh of CUDA devices"):
        count_pairs_sharded(ts1, ts2, pairs, chord2, mesh=mesh, backend="cuda")
    with pytest.raises(TypeError, match="Mesh"):
        count_pairs_sharded(ts1, ts2, pairs, chord2, mesh=["cpu", "cpu"])
    with pytest.raises(ValueError, match="processes"):
        count_pairs_sharded(
            ts1, ts2, pairs, chord2, mesh=Mesh(["cpu", "cpu"], ranks=[0, 1])
        )
    with pytest.raises(ValueError, match="rank-major"):
        Mesh(["cpu", "cpu"], ranks=[1, 0])
    with pytest.raises(ValueError, match="one type"):
        Mesh(["cpu", "cuda"])


def test_cuda_mesh_without_a_card_raises(problem):
    """No fallback: a mesh of CUDA devices never counts on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, (ts1, ts2, pairs, chord2) = problem
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        count_pairs_sharded(ts1, ts2, pairs, chord2, mesh=Mesh(["cuda:0"] * 2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        default_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        count_pairs_sharded(ts1, ts2, pairs, chord2)


class TestAutoMesh:
    """Automatic device-pool detection (the JAX package's ``TestAutoMesh``)."""

    def test_cpu_defaults_single_device(self):
        assert auto_mesh("cpu") is None

    def test_env_override_engages_devices(self, monkeypatch):
        monkeypatch.setenv("YAWT_NUM_DEVICES", "8")
        assert auto_mesh("cpu") == default_mesh(8, "cpu")
        monkeypatch.setenv("YAWT_NUM_DEVICES", "3")
        assert auto_mesh("cpu").size == 3
        monkeypatch.setenv("YAWT_NUM_DEVICES", "1")
        assert auto_mesh("cpu") is None

    def test_malformed_env_degrades_to_default(self, monkeypatch, caplog):
        monkeypatch.setenv("YAWT_NUM_DEVICES", "all")
        with caplog.at_level("WARNING"):
            assert auto_mesh("cpu") is None
        assert "YAWT_NUM_DEVICES" in caplog.text

    def test_bare_engine_call_engages_the_pool(self, problem, monkeypatch):
        """``count_pairs_tiles`` without a mesh routes through the sharded
        engine over the automatic pool, with the same counts."""
        _, (ts1, ts2, pairs, chord2) = problem
        single = count_pairs_tiles(ts1, ts2, pairs, chord2, device="cpu")
        seen = {}
        real = sharded.count_pairs_sharded

        def recorder(*args, **kwargs):
            seen["mesh"] = kwargs["mesh"]
            return real(*args, **kwargs)

        monkeypatch.setenv("YAWT_NUM_DEVICES", "4")
        monkeypatch.setattr(sharded, "count_pairs_sharded", recorder)
        pooled = count_pairs_tiles(ts1, ts2, pairs, chord2, device="cpu")
        assert seen["mesh"] == default_mesh(4, "cpu")
        assert_counts_close(pooled, single)
        seen.clear()
        count_pairs_tiles(ts1, ts2, pairs, chord2, device="cpu", mesh="single")
        assert not seen


class TestDistributedHelpers:
    """Single-process degradation of the process helpers."""

    def test_single_process_semantics(self):
        from yet_another_wizz_tpu_torch import parallel

        parallel.initialize()
        assert parallel.process_index() == 0
        assert parallel.num_processes() == 1
        assert parallel.on_root()
        parallel.barrier()
        payload = {"config": [1, 2, 3]}
        assert parallel.broadcast(payload) == payload
        assert parallel.run_on_root(lambda: 7) == 7
        assert parallel.broadcasted(lambda x: x + 1)(1) == 2
        assert distributed.picklable_exception(ValueError("x")).args == ("x",)

        class Local(Exception):
            pass

        wrapped = distributed.picklable_exception(Local("local class"))
        assert isinstance(wrapped, RuntimeError)

    def test_multihost_after_single_host_latch_raises(self):
        distributed.initialize()
        with pytest.raises(RuntimeError, match="single-host"):
            distributed.initialize(
                coordinator_address="127.0.0.1:9", process_count=2, process_id=1
            )
        distributed.initialize()

    def test_launched_world_size_detection(self, monkeypatch):
        for var in distributed._LAUNCHER_WORLD_SIZE_VARS:
            monkeypatch.delenv(var, raising=False)
        assert distributed._launched_world_size() is None
        monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "4")
        assert distributed._launched_world_size() == 4
        monkeypatch.delenv("OMPI_COMM_WORLD_SIZE")
        monkeypatch.setenv("SLURM_STEP_NUM_TASKS", "garbage")
        assert distributed._launched_world_size() is None
        monkeypatch.delenv("SLURM_STEP_NUM_TASKS")
        monkeypatch.setenv("SLURM_NTASKS", "4")
        assert distributed._launched_world_size() is None

    def test_launcher_after_single_host_latch_raises(self, monkeypatch):
        distributed.initialize()
        monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "2")
        with pytest.raises(RuntimeError, match="single-host"):
            distributed.initialize()
        monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "1")
        distributed.initialize()

    def test_ompi_cluster_from_the_launcher_environment(self, monkeypatch):
        """The coordinator, size and rank of an Open MPI launch, as the JAX
        package's cluster detection derives them (the inversion of
        ``tests/test_multiprocess.py::test_ompi_launcher_autodetect``)."""
        monkeypatch.delenv("OMPI_MCA_orte_hnp_uri", raising=False)
        assert distributed._ompi_cluster() is None
        port = 61440 + 123
        uri = f"{(port - 61440) * 2**12}.0;tcp://127.0.0.1,10.0.0.1:11111"
        monkeypatch.setenv("OMPI_MCA_orte_hnp_uri", uri)
        monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "2")
        monkeypatch.setenv("OMPI_COMM_WORLD_RANK", "1")
        assert distributed._ompi_cluster() == (f"127.0.0.1:{port}", 2, 1)
