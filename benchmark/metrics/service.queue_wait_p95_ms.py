"""95th percentile of the wait between a request's due time and the call
into `PoseService` (the benchmark's own span): the queue behind slower
answers."""

import numpy as np


def read(run):
    w = run.queue_waits_ms()
    return float(np.percentile(w, 95)) if w.size else None
