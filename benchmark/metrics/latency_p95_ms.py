"""95th percentile over every request of the window of due -> poses on the
host."""

import numpy as np


def read(run):
    lat = run.latencies_ms()
    return float(np.percentile(lat, 95)) if lat.size else None
