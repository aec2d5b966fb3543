"""Finds everything a cell needs by the names in ``BENCHMARK.json``.

Under the benchmark's folder, each configuration is ``configs/<name>.json``,
each traffic mix ``traffic/<name>.json``, each per-layer metric a reader
``metrics/<name>.py`` (a function ``read(run)`` that returns a number, or
None where it finds nothing to read), and each cell's limits of the check
``limits/<cell>.json``. A new cell or metric is new files and entries, with
no edit to a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


class Registry:
    def __init__(self, root: Path, folder: str = "benchmark") -> None:
        self.root = Path(root)
        self.folder = self.root / folder
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def _json(self, kind: str, name: str) -> dict:
        path = self.folder / kind / f"{name}.json"
        if not path.is_file():
            raise LookupError(f"no {kind} file for '{name}' ({path})")
        return json.loads(path.read_text())

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, cell: str) -> dict:
        return self._json("limits", cell)

    def reader(self, metric: str):
        path = self.folder / "metrics" / f"{metric}.py"
        if not path.is_file():
            raise LookupError(f"no reader for metric '{metric}' ({path})")
        spec = importlib.util.spec_from_file_location(
            f"bench_metric_{metric.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

    def cell(self, name: str) -> Cell:
        workloads = {w["name"]: w for w in self.spec["workloads"]}
        if name not in workloads:
            raise LookupError(f"no workload '{name}' in BENCHMARK.json")
        workload = workloads[name]

        def applies(metric):
            return name in metric.get("workloads", [name])

        return Cell(
            name=name, workload=workload,
            config=self.config(workload["config"]),
            traffic=self.traffic(workload["traffic"]),
            limits=self.limits(name),
            end_to_end=[m for m in self.spec["end_to_end"] if applies(m)],
            per_layer=[m for m in self.spec["per_layer"] if applies(m)],
        )
