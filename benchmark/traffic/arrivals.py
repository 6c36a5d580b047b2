"""Arrival schedules of an open loop: when each request is due."""

from __future__ import annotations

import numpy as np


def periodic(rate: float, seconds: float, jitter: float, rng: np.random.Generator) -> np.ndarray:
    """Due times (s from the window's start) of floor(rate * seconds)
    requests: one every 1 / rate, each moved by a uniform draw of
    +-jitter periods (jitter < 0.5 keeps their order)."""
    n = int(rate * seconds)
    return (np.arange(n) + 0.5 + rng.uniform(-jitter, jitter, n)) / rate


ARRIVALS = {"periodic": periodic}
