"""The result line carries exactly the contract's keys, with the compared
numbers last; without a card the command prints no result and fails."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, cpu_run

CONTRACT = ["attempted", "failed", "correct", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
def test_result_keys(tiny_root, tmp_path, trace):
    result = cpu_run(tiny_root, "inmem_mock.multiscale", tmp_path, trace=trace)
    line = json.loads(json.dumps(result))
    keys = list(line)
    assert keys[-1] == "checks"
    expected = CONTRACT + (["breakdown"] if trace else [])
    assert sorted(keys[:-1]) == sorted(expected)
    assert set(line["checks"]) == {"counts", "norm", "nz", "cov"}
    for entry in line["checks"].values():
        assert set(entry) == {"value", "limit"}
    for entry in line["metrics"].values():
        assert set(entry) == {"value", "unit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(line["breakdown"]["idle_gaps"]) <= 10
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1


def test_no_card_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
         "inmem_mock.multiscale", "--seed", "5", "--seconds", "1", "--trace", "0",
         "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no result" in proc.stderr


def test_no_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark, the
    run finds no program and gives no result."""
    import shutil
    import time
    import types

    from conftest import BENCH
    from harness.registry import Registry
    from harness.runner import RunError, run

    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    args = types.SimpleNamespace(workload="inmem_mock.multiscale", seed=1, seconds=0.1,
                                 trace=0, out=str(tmp_path / "out"))
    with pytest.raises(RunError, match="not from"):
        run(args, tmp_path, time.time(), device="cpu", registry=Registry(tmp_path))
