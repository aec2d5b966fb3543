"""The port's two-process execution: two CPU processes with a mesh of 2
entries each, joined by ``torch.distributed`` over gloo (modelled on
``tests/test_multiprocess.py``; the workers are
``tests/torch_multiprocess_worker.py``, which import no JAX).

- every layout over the global mesh of 2 x 2 shards equals, bit for bit,
  one process with a mesh of 4 (the partials of all shards are summed in
  shard order on every process), as do the automatic pool and
  ``crosscorrelate``; broadcast and a root-guarded write behave;
- a root-side error and a failed shard raise on every process;
- ``initialize()`` derives the job from an Open MPI environment, and raises
  the actionable error when it cannot;
- collective streaming ingestion writes, byte for byte, the cache of a
  single-process streaming ingest.

Each worker pair runs under a timeout of its own; a pair that times out or
fails to connect (a port taken between probe and bind) is retried once on
a fresh port, so a hang fails in seconds.
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

WORKER = Path(__file__).parent / "torch_multiprocess_worker.py"
REPO_ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 120.0
INFRASTRUCTURE = ("<timed out>", "DistNetworkError", "DistStoreError", "EADDRINUSE")
"""Outputs of a failed attempt that the single retry covers: a hang, or a
coordinator port that was taken."""


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _clean_env() -> dict:
    env = {
        key: value for key, value in os.environ.items()
        if not key.startswith(("YAWT_", "OMPI_"))
    }
    env["PYTHONPATH"] = str(REPO_ROOT)
    return env


def _run(envs: list[dict], mode: str, workdir: Path) -> list:
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), mode, str(workdir)], env=env,
            cwd=REPO_ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for env in envs
    ]
    results = []
    try:
        for proc in procs:
            try:
                out, _ = proc.communicate(timeout=TIMEOUT)
                results.append((proc.returncode, out))
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate()
                results.append((-1, (out or "") + "\n<timed out>"))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return results


def _launch(mode: str, workdir: Path, make_envs) -> list[str]:
    """Run a worker pair (``make_envs()`` gives each process's environment,
    drawn anew for the retry) and return the outputs; fail with them."""
    for attempt in range(2):
        results = _run(make_envs(), mode, workdir)
        outputs = "".join(out for _, out in results)
        if all(rc == 0 for rc, _ in results):
            return [out for _, out in results]
        if attempt == 0 and any(word in outputs for word in INFRASTRUCTURE):
            continue
        for rank, (rc, out) in enumerate(results):
            assert rc == 0, f"worker {rank} failed (rc={rc}):\n{out}"
    raise AssertionError(f"worker pair failed twice:\n{outputs}")


def _yawt_envs(**extra):
    def make():
        port = _free_port()
        return [
            dict(
                _clean_env(), YAWT_COORDINATOR=f"localhost:{port}",
                YAWT_NUM_PROCESSES="2", YAWT_PROCESS_ID=str(rank), **extra,
            )
            for rank in range(2)
        ]

    return make


def _write_catalogs(workdir: Path) -> None:
    from yet_another_wizz_tpu_torch.catalog import Catalog
    from yet_another_wizz_tpu_torch.examples import generate_mock_data

    mock = generate_mock_data(1200, 1800, 3000, seed=2)
    reference = Catalog.from_arrays(
        **mock["reference"], degrees=False, patch_num=4, device="cpu"
    )
    reference.to_cache(workdir / "reference")
    centers = reference.get_centers()
    for name in ("unknown", "randoms"):
        Catalog.from_arrays(
            **mock[name], degrees=False, patch_centers=centers, device="cpu"
        ).to_cache(workdir / name)


def test_two_process_engine(tmp_path):
    """Two processes x 2 shards equal one process x 4 shards bit for bit."""
    import torch_multiprocess_worker as worker

    from yet_another_wizz_tpu_torch.parallel import count_pairs_sharded, default_mesh

    ts1, ts2, pairs, chord2 = worker.tiny_problem()
    mesh = default_mesh(4, "cpu")
    expected = {
        layout: count_pairs_sharded(
            ts1, ts2, pairs, chord2, mesh=mesh, data_sharding=layout
        )
        for layout in worker.LAYOUTS
    }
    _write_catalogs(tmp_path)
    dd, rd = worker.crosscorrelate_counts(worker.open_catalogs(tmp_path), mesh, "ring")
    np.savez(tmp_path / "expected.npz", dd=dd, rd=rd, **expected)

    outputs = _launch("engine", tmp_path, _yawt_envs(YAWT_NUM_DEVICES="4"))
    assert all("ENGINE OK" in out for out in outputs)
    import h5py

    with h5py.File(tmp_path / "payload.hdf", "r") as f:
        assert int(f["value"][()]) == 0


def test_two_process_errors_propagate(tmp_path):
    """A root-only write into a non-empty cache raises on both processes,
    and a shard that fails on process 1 raises on both."""
    _write_catalogs(tmp_path)
    outputs = _launch("errors", tmp_path, _yawt_envs())
    assert all("ERRORS OK" in out for out in outputs)


def _free_port_in_ompi_range() -> int:
    """A bindable port in the range the Open MPI derivation draws from (the
    top 2^12 ports)."""
    for port in range(61440, 65536):
        with socket.socket() as sock:
            try:
                sock.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise RuntimeError("no free port in the Open MPI range")


def test_ompi_launcher_autodetect(tmp_path):
    """Workers given only the Open MPI environment (no YAWT_* wiring) form
    the job through ``initialize()``: the coordinator port is the one the
    derivation of the job id gives (inverted here, as in
    ``tests/test_multiprocess.py``)."""

    def make():
        port = _free_port_in_ompi_range()
        uri = f"{(port - 61440) * 2**12}.0;tcp://127.0.0.1,10.0.0.1:11111"
        return [
            dict(
                _clean_env(), OMPI_MCA_orte_hnp_uri=uri,
                OMPI_COMM_WORLD_SIZE="2", OMPI_COMM_WORLD_RANK=str(rank),
                OMPI_COMM_WORLD_LOCAL_RANK=str(rank),
            )
            for rank in range(2)
        ]

    outputs = _launch("ompi", tmp_path, make)
    assert all("OMPI OK" in out for out in outputs)


def test_ompi_launcher_unresolvable_raises(tmp_path):
    env = dict(_clean_env(), OMPI_COMM_WORLD_SIZE="2", OMPI_COMM_WORLD_RANK="0")
    result = subprocess.run(
        [sys.executable, str(WORKER), "ompi_error", str(tmp_path)], env=env,
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=TIMEOUT,
    )
    assert result.returncode == 0, result.stdout + result.stderr
    assert "OMPI ERROR OK" in result.stdout


def test_two_process_collective_ingest(tmp_path):
    """Root reads and assigns, both processes write the patches they own:
    the shared cache equals a single-process streaming ingest byte for
    byte (data and metadata)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from yet_another_wizz_tpu_torch.catalog import Catalog
    from yet_another_wizz_tpu_torch.coordinates import AngularCoordinates
    from yet_another_wizz_tpu_torch.examples import generate_mock_data

    sample = generate_mock_data(4000, 10, 10, seed=21)["reference"]
    pq.write_table(
        pa.table(dict(
            ra=np.rad2deg(sample["ra"]), dec=np.rad2deg(sample["dec"]),
            z=sample["redshifts"],
        )),
        str(tmp_path / "ingest.pqt"),
    )
    probe = Catalog.from_arrays(
        sample["ra"], sample["dec"], degrees=False, patch_num=5, device="cpu"
    )
    centers = probe.get_centers().data
    np.save(tmp_path / "centers.npy", centers)
    single = Catalog.from_file(
        tmp_path / "cache_sp", tmp_path / "ingest.pqt", ra_name="ra",
        dec_name="dec", redshift_name="z",
        patch_centers=AngularCoordinates(centers), degrees=True,
        streaming=True, chunksize=1000, device="cpu",
    )
    np.save(tmp_path / "expected_records.npy", np.asarray(single.get_num_records()))
    outputs = _launch("ingest", tmp_path, _yawt_envs())
    assert all("INGEST OK" in out for out in outputs)
