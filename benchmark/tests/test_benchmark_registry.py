"""The registry finds every file of a cell by its name, and a cell, a
configuration, a traffic mix and a metric added as new files and entries are
taken without an edit to any file that is there: among them a mix of
autocorrelations alone, a mix with the program's audit switched on, and a
mix whose patches the program makes itself."""

import json

import pytest

from conftest import ROOT, cpu_run
from harness.registry import Registry
from harness.session import kinds_of

CROSS = {"name": "cross", "fn": "cross",
         "catalogs": {"reference": "reference", "unknown": "unknown", "ref_rand": "randoms"}}
AUTO = {"name": "auto", "fn": "auto", "catalogs": {"data": "reference", "random": "randoms"}}
NEW_MIXES = {
    "auto_only": {"scales": "single", "catalogs": "setup",
                  "calls": [AUTO], "post": [{"corr": "auto"}]},
    "audited": {"scales": "single", "catalogs": "setup",
                "calls": [dict(CROSS, kwargs={"audit": True}),
                          dict(AUTO, kwargs={"audit": True})],
                "post": [{"nz": "cross", "ref_corr": "auto"}]},
    "own_patches": {"scales": "single", "catalogs": "each_measurement",
                    "patches": "program", "calls": [CROSS], "post": [{"nz": "cross"}]},
}


def test_every_cell_of_the_benchmark_resolves():
    registry = Registry(ROOT)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for workload in spec["workloads"]:
        cell = registry.cell(workload["name"])
        assert cell.config["name"] == workload["config"]
        assert {"scales", "calls", "post", "catalogs"} <= set(cell.traffic)
        assert cell.traffic["scales"] in cell.config["scales"]
        names = {call["name"] for call in cell.traffic["calls"]}
        for call in cell.traffic["calls"]:
            assert kinds_of(call)
            assert set(call["catalogs"].values()) <= {"reference", "unknown", "randoms"}
        for step in cell.traffic["post"]:
            assert {v for k, v in step.items() if v} <= names
        assert set(cell.limits) == {"counts", "norm", "nz", "cov", "edge_band", "slot_rtol"}
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        for metric in cell.end_to_end + cell.per_layer:
            assert callable(registry.reader(metric["name"]))
    for config in spec["configs"]:
        assert (ROOT / config["file"]).is_file()
        data = json.loads((ROOT / config["file"]).read_text())
        assert data["name"] == config["name"]
        assert data["source"] == config["source"]
        assert data["reduced"] == config["reduced"]


@pytest.fixture(scope="module")
def extended(tmp_path_factory):
    """A copy of the benchmark's data with a configuration, three traffic
    mixes, their cells and a metric added as new files and entries; the
    runs below take the harness's code as it is in the repository."""
    from conftest import make_tiny_root

    root = make_tiny_root(tmp_path_factory.mktemp("extended"))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    config = json.loads((root / "benchmark/configs/inmem_mock.json").read_text())
    config.update(name="dummy_config", num_patches=6)
    (root / "benchmark/configs/dummy_config.json").write_text(json.dumps(config))
    spec["configs"].append({"name": "dummy_config", "source": "a test",
                            "file": "benchmark/configs/dummy_config.json",
                            "reduced": [], "why": "a test"})
    limits = {"counts": 1e-4, "norm": 1e-9, "nz": 1e-3, "cov": 1e-2, "edge_band": 1e-6,
              "slot_rtol": 1e-6}
    for mix, traffic in NEW_MIXES.items():
        (root / f"benchmark/traffic/{mix}.json").write_text(json.dumps(traffic))
        (root / f"benchmark/limits/dummy_config.{mix}.json").write_text(json.dumps(limits))
        spec["workloads"].append({"name": f"dummy_config.{mix}", "config": "dummy_config",
                                  "traffic": mix, "chips": 1, "why": "a test"})
    (root / "benchmark/metrics/dummy.count_ms.py").write_text(
        "def read(run):\n    return 1.0 if run.trace is not None else None\n")
    spec["per_layer"].append({"name": "dummy.count_ms", "unit": "ms", "better": "lower",
                              "source": "program_span", "layer": "engine",
                              "moves": "measure_s",
                              "workloads": [f"dummy_config.{m}" for m in NEW_MIXES]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.mark.parametrize("mix", sorted(NEW_MIXES))
def test_a_new_cell_is_files_and_entries_only(extended, tmp_path, mix):
    cell = Registry(extended).cell(f"dummy_config.{mix}")
    assert cell.config["num_patches"] == 6
    assert [m["name"] for m in cell.per_layer][-1] == "dummy.count_ms"
    result = cpu_run(extended, f"dummy_config.{mix}", tmp_path, trace=1)
    assert result["correct"] is True, result["checks"]
    assert result["metrics"]["dummy.count_ms"]["value"] == 1.0
    record = json.loads((tmp_path / f"dummy_config.{mix}.1" / "run.json").read_text())
    counted = {work["count"] for work in record["works"]}
    expected = {f"{call['name']}_{kind}" for call in NEW_MIXES[mix]["calls"]
                for kind in kinds_of(call)}
    assert counted == expected
