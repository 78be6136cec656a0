"""The 95th percentile of every scoring request's time in the window, from
the host arrays to the probabilities on the host (host clock)."""

import numpy as np


def read(run):
    lat = run.window.latencies
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
