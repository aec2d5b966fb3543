"""Shared set-up of the benchmark's own tests (run with
``python -m pytest benchmark/tests``): the harness on the path, and a
registry root with every cell cut to a size the CPU holds."""

from __future__ import annotations

import json
import shutil
import sys
import time
import types
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(ROOT))

TINY = dict(num_reference=3000, num_unknown=6000, num_randoms=12000, num_patches=8,
            kmeans_probe=3000, region_deg=[40.0, 44.0, -2.0, 2.0])


def make_tiny_root(path: Path) -> Path:
    """A copy of the benchmark's registry with each configuration cut to
    ``TINY``."""
    bench = path / "benchmark"
    for folder in ("traffic", "metrics", "limits", "configs"):
        shutil.copytree(BENCH / folder, bench / folder)
    for config_path in (bench / "configs").glob("*.json"):
        config = json.loads(config_path.read_text())
        config.update(TINY)
        config_path.write_text(json.dumps(config))
    shutil.copy(ROOT / "BENCHMARK.json", path / "BENCHMARK.json")
    return path


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


def cpu_run(root: Path, workload: str, tmp: Path, *, seed: int = 2**33 + 5,
            seconds: float = 0.5, trace: int = 0) -> dict:
    """One run of ``workload`` on the CPU, from the registry at ``root``."""
    from harness.registry import Registry
    from harness.runner import run

    args = types.SimpleNamespace(workload=workload, seed=seed, seconds=seconds,
                                 trace=trace, out=str(tmp / f"{workload}.{trace}"))
    return run(args, ROOT, time.time(), device="cpu", registry=Registry(root))
