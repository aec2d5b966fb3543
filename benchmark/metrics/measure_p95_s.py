"""measure_p95_s: the 95th percentile of the seconds of every measurement
in the window (host clock)."""

import numpy as np


def read(run):
    if not run.durations:
        return None
    return float(np.percentile(np.asarray(run.durations), 95))
