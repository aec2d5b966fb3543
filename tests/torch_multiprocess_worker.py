"""Worker of the port's two-process tests (``tests/test_torch_multiprocess.py``).

Launched as ``python torch_multiprocess_worker.py <mode> <workdir>`` with
``YAWT_COORDINATOR`` / ``YAWT_NUM_PROCESSES`` / ``YAWT_PROCESS_ID`` set per
process (or, for the ``ompi`` modes, an Open MPI launcher's environment).
Each process holds a CPU mesh of 2 entries, so two workers form a global
mesh of 4 shards across the process boundary; the partials cross it over
gloo. Imports no JAX. Not collected by pytest (no ``test_`` prefix).
"""

import os
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from yet_another_wizz_tpu_torch import parallel  # noqa: E402

LAYOUTS = ("replicated", "columns", "ring")
CATALOG_NAMES = ("reference", "unknown", "randoms")
CONFIG = dict(rmin=500, rmax=3000, unit="kpc", zmin=0.15, zmax=1.0, num_bins=3)


def tiny_problem():
    """Tile sets, pair list and thresholds of a small cross count (3,000 x
    4,000 points in a 5 degree cap, 6 bins, 4 edges, tiles of 64), made
    from a seed with the port alone. It has one patch: every shard adds to
    its one slot, so the order of the cross-shard sum shows in the bits."""
    from yet_another_wizz_tpu_torch.ops.linkage import build_linkage, build_tile_pairs
    from yet_another_wizz_tpu_torch.ops.tiles import build_tile_set

    rng = np.random.default_rng(12345)
    num_bins, num_patches = 6, 1

    def cap(n):
        mu = rng.uniform(np.cos(np.deg2rad(5.0)), 1.0, n)
        phi = rng.uniform(0, 2 * np.pi, n)
        s = np.sqrt(1 - mu**2)
        return np.column_stack([s * np.cos(phi), s * np.sin(phi), mu])

    xyz1, xyz2 = cap(3000), cap(4000)
    centers = xyz1[rng.choice(len(xyz1), num_patches, replace=False)]
    patch1 = np.argmax(xyz1 @ centers.T, axis=1)
    patch2 = np.argmax(xyz2 @ centers.T, axis=1)
    ts1 = build_tile_set(
        xyz1, patch1, num_patches, weights=rng.uniform(0.5, 2.0, 3000),
        zbins=rng.integers(0, num_bins, 3000), num_bins=num_bins, tile_size=64,
    )
    ts2 = build_tile_set(
        xyz2, patch2, num_patches, weights=rng.uniform(0.5, 2.0, 4000),
        tile_size=64,
    )
    edges = np.deg2rad(np.tile((0.3, 0.7, 1.2, 2.0), (num_bins, 1)))
    chord2 = ((2 * np.sin(edges / 2)) ** 2).astype(np.float32)
    radii = np.array([
        2 * np.arcsin(min(1.0, np.linalg.norm(
            np.concatenate([xyz1[patch1 == p], xyz2[patch2 == p]]) - centers[p],
            axis=1,
        ).max() / 2))
        for p in range(num_patches)
    ])
    linkage = build_linkage(centers, radii, edges.max() * 1.000001)
    return ts1, ts2, build_tile_pairs(ts1, ts2, linkage, auto=False), chord2


def open_catalogs(workdir: Path):
    from yet_another_wizz_tpu_torch.catalog import Catalog

    return [Catalog(workdir / name) for name in CATALOG_NAMES]


def crosscorrelate_counts(catalogs, mesh, data_sharding):
    """DD and RD counts of ``crosscorrelate`` on the CPU under ``mesh``."""
    from yet_another_wizz_tpu_torch.config import Configuration
    from yet_another_wizz_tpu_torch.correlation.measurements import crosscorrelate

    (corr,) = crosscorrelate(
        Configuration.create(**CONFIG), catalogs[0], catalogs[1],
        ref_rand=catalogs[2], device="cpu", mesh=mesh,
        data_sharding=data_sharding,
    )
    return corr.dd.counts.counts, corr.rd.counts.counts


def check_cluster() -> int:
    parallel.initialize()
    assert parallel.num_processes() == 2, parallel.num_processes()
    return parallel.process_index()


def run_engine(workdir: Path) -> None:
    """Every layout on the global mesh of 2 x 2 shards equals the single
    process's 4-entry mesh bit for bit, as does the automatic pool and
    ``crosscorrelate``; broadcast and root-guarded writes behave."""
    from yet_another_wizz_tpu_torch.ops.paircount import count_pairs_tiles
    from yet_another_wizz_tpu_torch.utils.abc import HdfSerializable

    rank = check_cluster()
    expected = np.load(workdir / "expected.npz")
    ts1, ts2, pairs, chord2 = tiny_problem()
    mesh = parallel.default_mesh(4, "cpu")
    assert mesh.size == 4 and mesh.ranks == (0, 0, 1, 1), mesh
    assert mesh.local_shards() == [2 * rank, 2 * rank + 1]
    for layout in LAYOUTS:
        counts = parallel.count_pairs_sharded(
            ts1, ts2, pairs, chord2, mesh=mesh, data_sharding=layout
        )
        np.testing.assert_array_equal(counts, expected[layout], err_msg=layout)

    # YAWT_NUM_DEVICES=4: the automatic pool is the global mesh of 4
    assert parallel.auto_mesh("cpu") == mesh
    counts = count_pairs_tiles(ts1, ts2, pairs, chord2, device="cpu")
    np.testing.assert_array_equal(counts, expected["replicated"], err_msg="auto")

    catalogs = open_catalogs(workdir)
    dd, rd = crosscorrelate_counts(catalogs, mesh, "ring")
    np.testing.assert_array_equal(dd, expected["dd"])
    np.testing.assert_array_equal(rd, expected["rd"])

    value = parallel.broadcast({"rank": rank, "data": np.arange(5)})
    assert value["rank"] == 0, value
    np.testing.assert_array_equal(value["data"], np.arange(5))
    assert parallel.broadcast(rank, is_source=rank == 1) == 1

    class Payload(HdfSerializable):
        def __init__(self, value: int) -> None:
            self.value = value

        @classmethod
        def from_hdf(cls, source):
            return cls(int(source["value"][()]))

        def to_hdf(self, dest) -> None:
            dest.create_dataset("value", data=self.value)

    # both processes write different payloads; the file holds root's
    target = workdir / "payload.hdf"
    Payload(rank).to_file(target)
    assert Payload.from_file(target).value == 0
    parallel.barrier()
    print(f"ENGINE OK rank={rank}")


def run_errors(workdir: Path) -> None:
    """A root-side error and a failed shard raise on every process."""
    from yet_another_wizz_tpu_torch.parallel import sharded

    rank = check_cluster()
    assert parallel.run_on_root(lambda: {"rank": rank}) == {"rank": 0}

    # root-only I/O into a cache directory that is not empty
    catalogs = open_catalogs(workdir)
    try:
        catalogs[0].to_cache(workdir / "unknown")
    except FileExistsError as err:
        assert "not empty" in str(err), err
    else:
        raise AssertionError(f"rank {rank}: the root's error was not raised")

    ts1, ts2, pairs, chord2 = tiny_problem()
    if rank == 1:
        def failing(*args, **kwargs):
            raise ValueError("injected shard failure")

        sharded._count_shard = failing
    try:
        parallel.count_pairs_sharded(
            ts1, ts2, pairs, chord2, mesh=parallel.default_mesh(4, "cpu")
        )
    except RuntimeError as err:
        assert "failed on process 1" in str(err), err
        assert "injected" in str(err.__cause__), err.__cause__
    else:
        raise AssertionError(f"rank {rank}: the failed shard was not raised")
    parallel.barrier()
    print(f"ERRORS OK rank={rank}")


def run_ingest(workdir: Path) -> None:
    """Collective streaming ingestion: root reads and assigns, both
    processes write the patches they own; the cache equals the
    single-process streaming ingest byte for byte."""
    from yet_another_wizz_tpu_torch.catalog import Catalog

    rank = check_cluster()
    catalog = Catalog.from_file(
        workdir / "cache_mp", workdir / "ingest.pqt", ra_name="ra",
        dec_name="dec", redshift_name="z",
        patch_centers=np.load(workdir / "centers.npy"), degrees=True,
        streaming=True, chunksize=1000, device="cpu",
    )
    np.testing.assert_array_equal(
        catalog.get_num_records(), np.load(workdir / "expected_records.npy")
    )
    for pid in range(catalog.num_patches):
        for name in ("data.bin", "meta.yml"):
            mp = (workdir / "cache_mp" / f"patch_{pid}" / name).read_bytes()
            sp = (workdir / "cache_sp" / f"patch_{pid}" / name).read_bytes()
            assert mp == sp, f"patch {pid} {name} differs (rank {rank})"
    parallel.barrier()
    print(f"INGEST OK rank={rank}")


def run_ompi(workdir: Path) -> None:
    """Launched with only an Open MPI environment: ``initialize()`` derives
    the job from it."""
    assert "YAWT_COORDINATOR" not in os.environ
    parallel.initialize()
    rank = int(os.environ["OMPI_COMM_WORLD_RANK"])
    assert parallel.num_processes() == 2, parallel.num_processes()
    assert parallel.process_index() == rank, parallel.process_index()
    assert parallel.broadcast({"rank": rank}) == {"rank": 0}
    parallel.barrier()
    print(f"OMPI OK rank={rank}")


def run_ompi_error(workdir: Path) -> None:
    """A launcher's world size without a derivable coordinator raises the
    actionable error instead of latching single-process mode."""
    os.environ["OMPI_COMM_WORLD_SIZE"] = "2"
    os.environ.pop("OMPI_MCA_orte_hnp_uri", None)
    try:
        parallel.initialize()
    except RuntimeError as err:
        assert "YAWT_COORDINATOR" in str(err), err
        print("OMPI ERROR OK")
        return
    raise AssertionError("initialize() ignored the launcher environment")


def main() -> None:
    mode, workdir = sys.argv[1], Path(sys.argv[2])
    torch.set_num_threads(1)
    modes = dict(
        engine=run_engine, errors=run_errors, ingest=run_ingest, ompi=run_ompi,
        ompi_error=run_ompi_error,
    )
    modes[mode](workdir)


if __name__ == "__main__":
    main()
