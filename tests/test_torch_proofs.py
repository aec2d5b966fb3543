"""The port's survey proof script (``scripts/torch_survey_proof.py``) on the
CPU at a tiny size: 24k rows, 8 patches, 3 resident, reader rounds of
2,400 rows over Parquet row groups of 1,200, downsample 4.

- The whole script (prepare, the measurement subprocess, the crosscheck)
  passes every gate: the downsample's counts lie within 1e-6 of the
  float64 oracle, the full-scale n(z) is finite and its reduced chi^2
  against the downsample's is below 3, and every catalog took at least
  two reader rounds.
- Its record holds every key of the JAX script's record
  (``BENCH_oneshot_survey40m.json``), less those of ``probe_link`` and the
  ``devicemem`` snapshot, which are not ported.
- A failed gate makes the script exit non-zero and write no record.
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import json
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import torch_survey_proof as proof  # noqa: E402

TINY = ["--rows", "24000", "--patches", "8", "--resident", "3", "--ingest-chunk", "2400",
        "--parquet-chunk", "1200", "--downsample", "4", "--device", "cpu"]
NOT_PORTED = {"link", "resident_device_bytes"}
"""The JAX record's keys of ``probe_link`` and of the ``devicemem`` snapshot."""


def missing_keys(theirs: dict, ours: dict, prefix: str = "") -> list[str]:
    """The keys of ``theirs`` (recursively) that ``ours`` lacks."""
    missing = []
    for key, value in theirs.items():
        if key in NOT_PORTED:
            continue
        if key not in ours:
            missing.append(prefix + key)
        elif isinstance(value, dict) and value:
            missing += missing_keys(value, ours[key], f"{prefix}{key}.")
    return missing


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    root = tmp_path_factory.mktemp("survey_proof")
    out = root / "record.json"
    with pytest.MonkeyPatch.context() as mp:
        # one oracle worker and one torch thread in the measurement
        # subprocess: the test runner's other workers share the CPU, and
        # with every core's threads each the run took minutes
        mp.setenv("YAWT_NUM_THREADS", "1")
        mp.setenv("OMP_NUM_THREADS", "1")
        assert proof.main([*TINY, "--workdir", str(root / "work"), "--keep",
                           "--out", str(out)]) == 0
    return root, json.loads(out.read_text())


def test_every_gate_passes(record):
    _, rec = record
    assert rec["crosscheck"]["oracle_max_rel_err"] < 1e-6
    assert rec["measure"]["nz_finite"]
    assert rec["nz_full_vs_downsample_chi2"] < 3.0
    assert proof.gate_failures(rec) == []


def test_streaming_rounds_and_measurement(record):
    _, rec = record
    prepare, measure = rec["prepare"], rec["measure"]
    assert prepare["rows"] == {"reference": 3600, "unknown": 8400, "randoms": 12000}
    rounds = {name: info["rounds"] for name, info in prepare["ingestion_rounds"].items()}
    assert rounds == {"reference": 2, "unknown": 4, "randoms": 5}
    for name, info in prepare["ingestion_rounds"].items():
        assert sum(info["rows_per_round"]) == prepare["rows"][name]
    assert not prepare["patch_assignment_on_device"]
    assert measure["rows"] == 24000
    assert (measure["num_patches"], measure["max_resident_patches"]) == (8, 3)
    assert measure["num_block_pairs"] > 0 and measure["candidate_pairs"] > 0
    # the warm run reads every block from the packed-tile store
    assert measure["cold_counters"]["store_misses"] > 0
    assert measure["store_reads"]["misses"] == 0 and measure["store_reads"]["hits"] > 0
    assert measure["tile_store"]["stored_bytes"] > 0
    # the CPU runs the plain engine and calls no kernel wrapper
    assert measure["kernel_devices"] == [] and measure["launches"] == {}
    assert measure["plain_engine_devices"] == ["cpu"]
    assert measure["engine_kernel_ms"] is None  # no card: not measured
    for run in ("cold", "warm"):
        growth = measure["host_memory"][run]
        assert growth["peak_vmrss_bytes"] >= growth["baseline_vmrss_bytes"]
    assert len(rec["crosscheck"]["nz_data"]) == len(measure["nz_data"]) == 11


def test_record_keys_cover_the_jax_record(record):
    _, rec = record
    theirs = json.loads((REPO / "BENCH_oneshot_survey40m.json").read_text())
    assert missing_keys(theirs, rec) == []
    assert rec["card"] is None and rec["machine"]["nproc"] >= 1


def test_work_directory_removed_unless_kept(record, tmp_path, monkeypatch):
    root, rec = record
    assert (root / "work" / "cache_reference").is_dir()  # --keep
    monkeypatch.setattr(proof, "run_measurement", lambda workdir, args: rec["measure"])
    monkeypatch.setattr(proof, "crosscheck", lambda workdir, args: rec["crosscheck"])
    out = tmp_path / "again.json"
    assert proof.main([*TINY, "--workdir", str(tmp_path / "work"), "--out", str(out)]) == 0
    assert out.exists() and not (tmp_path / "work").exists()


@pytest.mark.parametrize("fault", ["nz", "oracle", "rounds", "plain_on_card"])
def test_failed_gate_exits_nonzero_without_record(record, tmp_path, monkeypatch, fault):
    _, rec = record
    prepare, measure, check = (
        json.loads(json.dumps(rec[key])) for key in ("prepare", "measure", "crosscheck")
    )
    if fault == "nz":
        check["nz_data"] = list(np.array(check["nz_data"]) + 10 * np.array(check["nz_error"]))
    elif fault == "oracle":
        check["oracle_max_rel_err"] = 2e-6
    elif fault == "rounds":
        prepare["ingestion_rounds"]["reference"]["rounds"] = 1
    else:
        measure["plain_engine_devices"] = ["cpu", "cuda:0"]
    monkeypatch.setattr(proof, "prepare", lambda workdir, args: prepare)
    monkeypatch.setattr(proof, "run_measurement", lambda workdir, args: measure)
    monkeypatch.setattr(proof, "crosscheck", lambda workdir, args: check)
    out = tmp_path / "r.json"
    assert proof.main([*TINY, "--workdir", str(tmp_path / "work"), "--out", str(out)]) == 1
    assert not out.exists()
