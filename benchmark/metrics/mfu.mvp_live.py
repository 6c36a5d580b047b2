"""The MvP request's share of the card's bf16 peak: the FLOPs of one
request (`counts/mvp.py`: the Pose-ResNet-50 trunk and transposed convs
over the 5 views, no output conv; the values; the decoder) over the
median request's latency, in %."""

import numpy as np


def read(run):
    lat = run.latencies_ms()
    if not lat.size or "bf16_flops" not in run.peaks or not run.flops_per_request:
        return None
    return 100.0 * run.flops_per_request / (np.percentile(lat, 50) * 1e-3) / run.peaks["bf16_flops"]
