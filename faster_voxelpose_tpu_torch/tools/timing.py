"""Timing on the card for the tools and the smoke run: CUDA events around
single calls.  It takes the place of the scan-slope method of the JAX
package's scripts, which exists for a device behind a high-latency
dispatch path; a CUDA event pair reads the device's own clock.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable

import numpy as np
import torch


def card_line() -> str:
    """The first card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def device_line(device: torch.device) -> str:
    """What a printed time was taken on: the card with its power limit, or
    the CPU (then the time is a host clock's, not a device metric)."""
    return card_line() if device.type == "cuda" else "CPU, host clock"


def time_ms(fn: Callable[[], object], reps: int = 25, warm: int = 3,
            device: torch.device = torch.device("cuda")) -> float:
    """Median of `reps` single-call times after `warm` calls: by CUDA
    events on the card, by the host clock for the CPU."""
    for _ in range(warm):
        fn()
    if device.type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))
