#!/usr/bin/env python3
"""Readings that set a cell's limits: the program's numbers and the
control's, at the cell's own size, over several seeds, in one process.

For each seed it makes the cell's inputs, builds the system and runs one
measurement through the timed path (as the window does), then computes the
reference in float64 and the control (the same reference in float32, the
precision below the configuration's) and prints, per seed, the check's
numbers for the program against the reference and for the control against
the reference. The benchmark's own runs do not run it. Run from the root of
a checkout with a CUDA card::

    python3 benchmark/control.py --workload inmem_mock.multiscale \\
        --seeds 101 102 103
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


BANDS = (2.0**-22, 2.0**-20, 2.0**-18, 2.0**-16, 2.0**-14)
"""Edge bands read besides the cell's own, to show where the program's
readings settle."""


def readings(cell, seed: int, device: str) -> dict:
    import torch

    from harness import check, inputs
    from harness.session import Session, Spans, extract

    data = inputs.make_inputs(cell.config, seed)
    row = {"seed": seed}
    session = Session(cell.config, cell.traffic, data, device, Spans())
    session.setup()
    session.measure()
    t0 = time.perf_counter()
    actual = extract(session.measure(), cell.traffic)
    row["measure_s"] = time.perf_counter() - t0
    session.close()
    del session
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bands = (cell.limits["edge_band"],) + BANDS
    desired, works = check.reference_measurement(cell.config, cell.traffic, data,
                                                 device, bands=bands,
                                                 centers=actual["centers"])
    row["reference_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lower, _ = check.reference_measurement(cell.config, cell.traffic, data, device,
                                           dtype=torch.float32,
                                           centers=actual["centers"])
    row["control_s"] = time.perf_counter() - t0
    row["program"] = check.compare(actual, desired, cell.limits)
    row["control"] = check.compare(lower, desired, cell.limits)
    row["program_by_band"] = {
        f"{band:.3g}": check.compare(actual, desired, cell.limits, level)
        for level, band in enumerate(bands)}
    row["program_widest"] = check.widest_count_gap(actual, desired)
    row["control_widest"] = check.widest_count_gap(lower, desired)
    row["pairs_in_reach"] = {w["count"]: w["pairs_in_reach"] for w in works}
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(ROOT))
    import torch

    from harness.registry import Registry
    from harness.runner import pin_caches

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    pin_caches(ROOT)
    cell = Registry(ROOT).cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
