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

`scan_slope` times a whole step (a frame through the model) as the JAX
package's bench.py does: F steps chained by a scalar carry, captured into
one CUDA graph (the counterpart of one `lax.scan` dispatch), the per-step
time the slope between two lengths F1 < F2, on the host's clock up to
the outputs on the host and on the device's clock.
"""

from __future__ import annotations

import subprocess
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine import graphs


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


Step = Callable[[torch.Tensor, Tuple[torch.Tensor, ...]], Tuple[torch.Tensor, Any]]


def scan(step: Step, xs: Sequence[torch.Tensor], length: int,
         carry: torch.Tensor) -> torch.Tensor:
    """`lax.scan` of `step(carry, x) -> (carry, out)` over `length` steps,
    step i taking x = tuple(x[i] for x in xs); the outputs stacked."""
    outs = []
    for i in range(length):
        carry, out = step(carry, tuple(x[i] for x in xs))
        outs.append(out)
    return torch.stack(outs)


class ScanTime(NamedTuple):
    """One length's reading: the least of `reps` runs on the host's clock
    (ms, up to the outputs on the host) and on the device's (ms, None on
    the CPU), the outputs of the last run on the host, and the kernel
    launches of one replay of the graph (empty on the CPU)."""

    host_ms: float
    device_ms: Optional[float]
    outputs: torch.Tensor
    launches: Dict[str, int]


def scan_time(step: Step, xs: Sequence[torch.Tensor], length: int, device: torch.device,
              reps: int = 3) -> ScanTime:
    """`scan` of `length` steps from a zero carry, on inputs `xs` already on
    `device`.  On the card it runs once eagerly on a side stream (cuDNN
    and cuBLAS choose their algorithms there), is captured into one CUDA
    graph (`engine.graphs.capture`, its own memory pool, inference mode)
    and the graph is replayed `reps` times, each replay between two CUDA
    events and followed by a copy of its outputs to the host; the graph
    and its pool are freed before returning.  On the CPU the scan runs
    eagerly, once to warm up and then `reps` times."""
    carry = torch.zeros((), device=device)
    run = lambda: scan(step, xs, length, carry)  # noqa: E731
    if device.type != "cuda":
        with torch.inference_mode():
            run()
            best, out = np.inf, None
            for _ in range(reps):
                t0 = time.perf_counter()
                out = run().cpu()
                best = min(best, (time.perf_counter() - t0) * 1e3)
        return ScanTime(best, None, out, {})
    stream = torch.cuda.Stream(device)
    graphs.run_on(stream, run, inference=True)
    captured = graphs.capture(run, stream, inference=True)
    best_host = best_dev = np.inf
    try:
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            a.record()
            graphs.replay(captured)
            b.record()
            out = captured.outputs.cpu()
            best_host = min(best_host, (time.perf_counter() - t0) * 1e3)
            best_dev = min(best_dev, a.elapsed_time(b))
        return ScanTime(best_host, best_dev, out, dict(captured.launches))
    finally:
        del captured
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


class Slope(NamedTuple):
    """Per-step ms between two scan lengths on both clocks (device None on
    the CPU), and each length's reading."""

    host_ms: float
    device_ms: Optional[float]
    short: ScanTime
    long: ScanTime


def scan_slope(step: Step, n1: int, n2: int, device: torch.device,
               inputs: Callable[[int], Sequence[torch.Tensor]] = lambda n: (),
               reps: int = 3) -> Slope:
    """The per-step time of `step` as the slope between scans of n1 < n2
    steps (`scan_time`): what the scan's launch, the copy of its outputs
    and any constant cost add cancels.  `inputs(F)` stages the F steps'
    inputs on `device` (each tensor's first axis the step); the inputs
    and the graph of one length are freed before the next is made."""
    if not 0 < n1 < n2:
        raise ValueError(f"scan lengths must be 0 < n1 < n2, got {n1}, {n2}")
    short = scan_time(step, inputs(n1), n1, device, reps)
    long = scan_time(step, inputs(n2), n2, device, reps)
    dev = None if short.device_ms is None else (long.device_ms - short.device_ms) / (n2 - n1)
    return Slope((long.host_ms - short.host_ms) / (n2 - n1), dev, short, long)
