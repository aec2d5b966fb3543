"""The port's tomographic proof script (``scripts/torch_tomo_pipeline_proof.py``).

- Its ``pipeline.log`` parsers (copies of the JAX script's) on the cases of
  ``tests/test_tomo_proof_logic.py``.
- The script's setup on the script's Parquet inputs (20k rows, 2 bins, 8
  patches, 8 resident: blocks of 4, lazy) through the port's command line
  in the script's subprocess (``--device cpu``) and through the JAX
  command line (float lanes, as in the other parity tests): every bin's
  estimated n(z) and its errors agree within 1e-6 (relative, with a floor
  of 1e-6 of the largest value: the files hold seven significant digits).
- A failed gate makes the script exit non-zero and write no record.
- The ``h5py`` stand-in stores and reads back the port's pair counts.
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import json
import sys
from pathlib import Path

import numpy as np
import pytest
from numpy.testing import assert_allclose

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

import torch_tomo_pipeline_proof as proof  # noqa: E402

from yet_another_wizz_tpu.cli.commandline import main as jax_main  # noqa: E402
from yet_another_wizz_tpu.redshifts import RedshiftData as JaxRedshiftData  # noqa: E402

TINY = ["--rows", "20000", "--bins", "2", "--patches", "8", "--resident", "8",
        "--downsample", "4", "--device", "cpu"]
RTOL = 1e-6

def stamp(seconds: float) -> str:
    whole, frac = divmod(round(seconds * 1000), 1000)
    minutes, secs = divmod(whole, 60)
    return f"2026-08-20 07:{minutes:02d}:{secs:02d},{frac:03d}"


TASK_CASES = {
    "pairs_timed_from_timestamps": ([
        f"{stamp(0)} INFO yawt.cli running task 'cache_ref'",
        f"{stamp(1.5)} INFO yawt.cli task 'cache_ref' finished after 0m01.50s",
        f"{stamp(1.5)} INFO yawt.cli running task 'cross_corr'",
        f"{stamp(31.25)} INFO yawt.cli task 'cross_corr' finished after 0m29.75s",
    ], {"cache_ref": 1.5, "cross_corr": 29.8}),
    "unrelated_and_malformed_lines_ignored": ([
        f"{stamp(0)} DEBUG yawt.engine counting DD",
        "not a log line at all",
        f"{stamp(0)} INFO yawt.cli running task 'hist'",
        f"{stamp(0)} INFO yawt.cli running 7 task(s)",
        f"{stamp(2)} INFO yawt.cli task 'hist' finished after 0m02.00s",
    ], {"hist": 2.0}),
    "unmatched_finish_or_start_dropped": ([
        f"{stamp(0)} INFO yawt.cli task 'estimate' finished after 0m09.00s",
        f"{stamp(5)} INFO yawt.cli running task 'plot'",
    ], {}),
    "repeated_task_accumulates": ([
        f"{stamp(0)} INFO yawt.cli running task 'cross_corr'",
        f"{stamp(1)} INFO yawt.cli task 'cross_corr' finished after 0m01.00s",
        f"{stamp(1)} INFO yawt.cli running task 'cross_corr'",
        f"{stamp(3.5)} INFO yawt.cli task 'cross_corr' finished after 0m02.50s",
    ], {"cross_corr": 3.5}),
}

BIN_CASES = {
    "marginal_bin_walls": ([
        f"{stamp(0)} CLIENT yawt.cli running task 'cross_corr'",
        f"{stamp(2)} CLIENT yawt.cli.tasks processing bin 1 / 3",
        f"{stamp(32)} CLIENT yawt.cli.tasks processing bin 2 / 3",
        f"{stamp(42)} CLIENT yawt.cli.tasks processing bin 3 / 3",
        f"{stamp(52.5)} CLIENT yawt.cli task 'cross_corr' finished after 0m52.50s",
    ], {"cross_corr": [30.0, 10.0, 10.5]}),
    "bins_scoped_per_task": ([
        f"{stamp(0)} CLIENT yawt.cli running task 'auto_unk'",
        f"{stamp(1)} CLIENT yawt.cli.tasks processing bin 1 / 2",
        f"{stamp(5)} CLIENT yawt.cli.tasks processing bin 2 / 2",
        f"{stamp(8)} CLIENT yawt.cli task 'auto_unk' finished after 0m08.00s",
        f"{stamp(8)} CLIENT yawt.cli running task 'cross_corr'",
        f"{stamp(10)} CLIENT yawt.cli.tasks processing bin 1 / 2",
        f"{stamp(20)} CLIENT yawt.cli.tasks processing bin 2 / 2",
        f"{stamp(25)} CLIENT yawt.cli task 'cross_corr' finished after 0m17.00s",
    ], {"auto_unk": [4.0, 3.0], "cross_corr": [10.0, 5.0]}),
    "no_bin_lines_yields_empty": ([
        f"{stamp(0)} CLIENT yawt.cli running task 'hist'",
        f"{stamp(2)} CLIENT yawt.cli task 'hist' finished after 0m02.00s",
    ], {}),
}


def write_log(tmp_path, lines):
    path = tmp_path / "pipeline.log"
    path.write_text("\n".join(lines) + "\n")
    return path


@pytest.mark.parametrize("case", sorted(TASK_CASES))
def test_parse_task_walls(tmp_path, case):
    lines, expected = TASK_CASES[case]
    assert proof.parse_task_walls(write_log(tmp_path, lines)) == expected


@pytest.mark.parametrize("case", sorted(BIN_CASES))
def test_parse_bin_walls(tmp_path, case):
    lines, expected = BIN_CASES[case]
    assert proof.parse_bin_walls(write_log(tmp_path, lines)) == expected


def test_parsers_equal_the_jax_scripts(tmp_path):
    """The copies parse every case as the JAX script's functions do."""
    from tomo_pipeline_proof import parse_bin_walls, parse_task_walls

    for cases, ours, theirs in (
        (TASK_CASES, proof.parse_task_walls, parse_task_walls),
        (BIN_CASES, proof.parse_bin_walls, parse_bin_walls),
    ):
        for lines, _ in cases.values():
            path = write_log(tmp_path, lines)
            assert ours(path) == theirs(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The script's inputs and setup, run by the port's command line (the
    script's subprocess) and by the JAX command line."""
    workdir = tmp_path_factory.mktemp("tomo_proof")
    args = proof.parse_args(TINY)
    prepared = proof.prepare(workdir, args)
    rows = sum(prepared["rows"].values())
    with pytest.MonkeyPatch.context() as mp:
        # one torch thread in the pipeline's subprocess: the test runner's
        # other workers share the CPU
        mp.setenv("OMP_NUM_THREADS", "1")
        port = proof.run_pipeline(workdir, workdir / "project", args, rows, small=False)
        mp.setenv("YAWT_LANE_ENCODING", "float")
        assert jax_main([str(workdir / "jax"), str(workdir / "setup.yml"), "--quiet"]) == 0
    return workdir, args, port


def test_estimates_equal_the_jax_command_line(runs):
    workdir, args, _ = runs
    ours = proof.load_estimates(workdir / "project", args.bins)
    for index in range(1, args.bins + 1):
        theirs = JaxRedshiftData.from_files(workdir / "jax" / "estimate" / f"nz_est_{index}")
        finite = np.isfinite(theirs.data)
        assert finite.sum() >= 4, index
        # the files hold seven significant digits: the floor is relative to
        # the largest value, as in tests/test_torch_cli.py
        for ours_part, theirs_part in ((ours[index]["nz_data"], theirs.data),
                                       (ours[index]["nz_error"], theirs.error)):
            floor = RTOL * np.nanmax(np.abs(theirs_part))
            assert_allclose(ours_part, theirs_part, rtol=RTOL, atol=floor)


def test_pipeline_subprocess_report(runs):
    workdir, args, port = runs
    assert set(port["task_walls_s"]) == {
        "cache_ref", "cache_unk", "auto_ref", "cross_corr", "hist", "estimate"
    }
    assert len(port["bin_walls_s"]["cross_corr"]) == args.bins
    # the CPU runs the plain engine and calls no kernel wrapper
    assert port["kernel_devices"] == [] and port["plain_engine_devices"] == ["cpu"]
    assert port["launches"] == {}
    assert port["tile_cache"]["caches"] == 1 and port["tile_cache"]["hits"] > 0
    assert port["host_memory"]["peak_vmrss_bytes"] >= port["host_memory"]["baseline_vmrss_bytes"]
    assert port["pair_counts_stored_through"].startswith("h5py ")


def doctored(nz_data):
    hist = np.zeros(11)
    hist[np.argmax(nz_data)] = 1.0
    return dict(nz_data=np.array(nz_data, float), nz_error=np.ones(11), hist_data=hist)


@pytest.mark.parametrize("fault", ["nan", "offset", "peak"])
def test_failed_gate_exits_nonzero_without_record(tmp_path, monkeypatch, fault):
    base = np.linspace(1.0, 2.0, 11)
    full = {1: doctored(base), 2: doctored(base)}
    down = {1: doctored(base), 2: doctored(base)}
    if fault == "nan":
        full[2]["nz_data"][3] = np.nan
    elif fault == "offset":
        down[1]["nz_data"] = base + 5.0
    else:
        full[1]["hist_data"] = np.roll(full[1]["hist_data"], 1)
    stages = iter([full, down])
    run = {"launches": {}, "plain_engine_devices": ["cpu"]}
    monkeypatch.setattr(proof, "prepare", lambda workdir, args: {"rows": {"a": 1}})
    monkeypatch.setattr(proof, "run_pipeline", lambda *a, **k: dict(run))
    monkeypatch.setattr(proof, "load_estimates", lambda project, bins: next(stages))
    out = tmp_path / "record.json"
    assert proof.main([*TINY, "--workdir", str(tmp_path / "w"), "--out", str(out)]) == 1
    assert not out.exists()
    # the same stages undoctored pass
    stages = iter([{1: doctored(base), 2: doctored(base)}] * 2)
    assert proof.main([*TINY, "--workdir", str(tmp_path / "w"), "--out", str(out)]) == 0
    record = json.loads(out.read_text())
    assert record["mean_full_vs_downsample_chi2"] == 0.0


def test_h5py_standin_round_trip(runs, monkeypatch):
    """The port's pair counts stored through the stand-in read back equal."""
    import torch_h5py_standin

    from yet_another_wizz_tpu_torch.correlation import load_corrfunc

    workdir, _, _ = runs
    stored = load_corrfunc(workdir / "project" / "paircounts" / "cross_1.hdf")
    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setattr("importlib.util.find_spec", lambda name, *a: None)
    del sys.modules["h5py"]
    assert torch_h5py_standin.ensure_h5py() == torch_h5py_standin.STANDIN
    assert torch_h5py_standin.ensure_h5py() == torch_h5py_standin.STANDIN
    path = workdir / "standin.hdf"
    stored.to_file(path)
    loaded = load_corrfunc(path)
    for name in ("dd", "dr", "rd", "rr"):
        ours, theirs = getattr(loaded, name), getattr(stored, name)
        assert (ours is None) == (theirs is None)
        if ours is not None:
            assert np.array_equal(ours.counts.get_array(), theirs.counts.get_array())
            assert np.array_equal(ours.sum_weights.get_array(), theirs.sum_weights.get_array())
