"""Median over the traced requests of the share of the request's span
(call into the service -> poses decoded) in which no kernel or copy ran
on the device."""

import numpy as np


def read(run):
    if not run.trace or not run.trace["request_busy_share"]:
        return None
    return float(np.median([1.0 - s for s in run.trace["request_busy_share"]]))
