"""The check excuses a slot moved within its tolerance (pairs within the
edge band, float32 sums) and no further; n(z) follows the counts it
excused."""

import copy

import numpy as np

from harness import check, inputs
from harness.registry import Registry


def test_tolerance(tiny_root):
    cell = Registry(tiny_root).cell("inmem_mock.multiscale")
    limits = dict(cell.limits, edge_band=1e-3)
    data = inputs.make_inputs(cell.config, 2**36 + 3)
    desired, _ = check.reference_measurement(cell.config, cell.traffic, data, "cpu",
                                             bands=(limits["edge_band"],))
    actual = copy.deepcopy(desired)
    assert check.compare(actual, desired, limits) == dict.fromkeys(check.NUMBERS, 0.0)
    key = "cross_dd"
    moves = desired["moves"][key][0]
    slot = np.unravel_index(np.argmax(moves), moves.shape)
    assert moves[slot] > 0
    actual["counts"][key][slot] += 0.9 * moves[slot]
    actual["post"] = check.post(desired, actual["counts"])
    numbers = check.compare(actual, desired, limits)
    assert numbers["counts"] == 0.0 and numbers["nz"] < 1e-12
    actual["counts"][key][slot] += 2.0 * moves[slot]
    actual["post"] = check.post(desired, actual["counts"])
    assert check.compare(actual, desired, limits)["counts"] > 0.0
