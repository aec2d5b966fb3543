"""The control, the reference computed in float32 in the program's place,
comes out not correct under every cell's limits, at a size a test run holds
(the readings at each cell's own size, on the card, are in PERF.md)."""

import json

import pytest
import torch

from conftest import ROOT
from harness import check, inputs
from harness.registry import Registry

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(tiny_root, workload):
    cell = Registry(tiny_root).cell(workload)
    data = inputs.make_inputs(cell.config, 2**35 + 11)
    desired, _ = check.reference_measurement(cell.config, cell.traffic, data, "cpu",
                                             bands=(cell.limits["edge_band"],))
    control, _ = check.reference_measurement(cell.config, cell.traffic, data, "cpu",
                                             dtype=torch.float32)
    again, _ = check.reference_measurement(cell.config, cell.traffic, data, "cpu")
    assert check.judge(check.compare(again, desired, cell.limits), cell.limits)
    numbers = check.compare(control, desired, cell.limits)
    assert not check.judge(numbers, cell.limits), numbers
