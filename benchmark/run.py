#!/usr/bin/env python3
"""Benchmark of ``yet_another_wizz_tpu_torch`` on one NVIDIA card: one run
of one cell of ``BENCHMARK.json``.

Run from the root of a checkout::

    python3 benchmark/run.py --workload inmem_mock.multiscale --seed 7 \\
        --seconds 10 --trace 0

The last line of standard output is the result, a JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (with
``--trace 1`` also ``breakdown``) and, last, ``checks``: each number the
check compared, beside its limit; the same numbers are the last lines of
standard error. Without a CUDA card, or without the program in the
checkout, it exits non-zero and prints no result. The run writes its record
(and, traced, its Chrome trace) under ``bench_out/`` or ``--out``.
"""

from __future__ import annotations

import time

STARTED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def parse(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--out", default=None,
                        help="directory of the run's record (default bench_out/)")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(ROOT))
    from harness.runner import RunError, run

    try:
        result = run(args, ROOT, STARTED)
    except RunError as error:
        print(f"no result: {error}", file=sys.stderr, flush=True)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
