"""Timing on the card for the tools and the smoke run.  It takes the place
of the scan-slope method of the JAX package's scripts, which exists for a
device behind a high-latency dispatch path; a CUDA event pair reads the
device's own clock.  Three readings of one call:

time_ms    the median of single calls, each between two CUDA events: the
           device time of the call plus the host's cost of launching it,
           which is 0.03-0.15 ms on the card's machine;
device_timing
           the device time alone (`device_ms` in the smoke run's lines):
           n calls captured in one CUDA graph, replayed between two events
           and divided by n (the median of `reps` replays); where the call
           cannot be captured, n calls back to back between two events, so
           that the launches overlap the device's work;
host_ms    the host's wall time per call when n calls are issued back to
           back and the device is synchronised once at the end, what a
           caller's loop sees.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, Optional, Tuple

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


class Clock:
    """A stopwatch on the device's clock (CUDA events on the current
    stream) or, for the CPU, on the host's; `stop` returns milliseconds
    since `start`."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self) -> None:
        if self.cuda:
            self._a = torch.cuda.Event(enable_timing=True)
            self._a.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> float:
        if not self.cuda:
            return (time.perf_counter() - self._t0) * 1e3
        b = torch.cuda.Event(enable_timing=True)
        b.record()
        b.synchronize()
        return self._a.elapsed_time(b)


def per_call_ms(totals, n: int) -> float:
    """The median of `totals` (ms, each of n calls) divided by n."""
    return float(np.median(totals)) / n


def _graph_of(fn: Callable[[], object], n: int):
    """A CUDA graph of n calls of fn, or None where fn cannot be captured
    (a host synchronisation, an allocation the graph's pool refuses)."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()  # a call outside the graph, on the capture's stream
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
        return graph
    except RuntimeError:
        torch.cuda.synchronize()
        return None


def device_timing(fn: Callable[[], object], n: int = 20, reps: int = 5, warm: int = 3,
                  device: torch.device = torch.device("cuda"),
                  clock: Optional[Clock] = None) -> Tuple[float, str]:
    """Device time per call of fn, without the host's launch cost, and the
    method that read it: "graph", a CUDA graph of n calls replayed `reps`
    times, each replay between two events, the median divided by n; or
    "back to back", n calls per reading, where fn cannot be captured and
    always on the CPU (then it is a host clock's time).  `clock` replaces
    the stopwatch (tests)."""
    clock = clock or Clock(device)
    for _ in range(warm):
        fn()
    graph = _graph_of(fn, n) if device.type == "cuda" else None
    run = graph.replay if graph is not None else lambda: [fn() for _ in range(n)]
    run()
    totals = []
    for _ in range(reps):
        clock.start()
        run()
        totals.append(clock.stop())
    return per_call_ms(totals, n), "graph" if graph is not None else "back to back"


def host_ms(fn: Callable[[], object], n: int = 20, reps: int = 5, warm: int = 3,
            device: torch.device = torch.device("cuda"),
            now: Callable[[], float] = time.perf_counter) -> float:
    """Host wall time per call of fn: n calls issued back to back, the
    device synchronised once at the end; the median of `reps` readings
    divided by n.  `now` replaces the host clock (tests)."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    for _ in range(warm):
        fn()
    sync()
    totals = []
    for _ in range(reps):
        t0 = now()
        for _ in range(n):
            fn()
        sync()
        totals.append((now() - t0) * 1e3)
    return per_call_ms(totals, n)
