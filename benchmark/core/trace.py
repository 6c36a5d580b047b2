"""A traced segment: `torch.profiler` over a callable, its Chrome trace
read back and reduced (a frozen copy of the arithmetic of the port's
`tools/analyze_trace.py`): device time by name, the union of the
device's intervals, the busy time inside each request's span, and the
longest idle gaps with the host operation running at each."""

from __future__ import annotations

import collections
import json
import os
import tempfile
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
REQUEST_SPAN = "benchmark.request"
NAME_CHARS = 160  # kernel names in the breakdown, cut (templates run to kilobytes)


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[list] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return [tuple(m) for m in merged]


def covered(merged: List[Tuple[float, float]], lo: float, hi: float) -> float:
    """How much of [lo, hi) the merged intervals cover."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged)


def host_op_at(host: List[dict], t: float) -> str:
    best = None
    for e in host:
        ts, dur = float(e["ts"]), float(e["dur"])
        if ts <= t < ts + dur and (best is None or ts >= float(best["ts"])):
            best = e
    return "(none)" if best is None else str(best.get("name", "?"))


def analyze(events: List[dict], top_n: int = 10) -> dict:
    """Readings of a trace's events, times in seconds: per-name device
    totals, busy (union of device intervals), the traced window (first
    request span's start to the last one's end), per-request busy
    shares, the longest idle gaps inside the window."""
    complete = [e for e in events if e.get("ph") == "X" and "ts" in e]
    dev = [e for e in complete if e.get("cat") in DEVICE_CATS]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                   for e in complete if e.get("name") == REQUEST_SPAN)
    total: Dict[str, float] = collections.Counter()
    count: Dict[str, int] = collections.Counter()
    for e in dev:
        total[e["name"]] += float(e.get("dur", 0.0))
        count[e["name"]] += 1
    merged = union([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in dev])
    if spans:
        lo, hi = spans[0][0], spans[-1][1]
    else:
        lo, hi = (merged[0][0], merged[-1][1]) if merged else (0.0, 0.0)
    busy = covered(merged, lo, hi)
    inside = [(a, b) for a, b in merged if b > lo and a < hi]
    host = [e for e in complete if e.get("cat") in HOST_CATS and "dur" in e]
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(inside, inside[1:])), reverse=True)
    return {
        "device_events": len(dev),
        "total_s": {k: v * 1e-6 for k, v in total.items()},
        "count": dict(count),
        "busy_s": busy * 1e-6,
        "window_s": (hi - lo) * 1e-6,
        "request_busy_share": [covered(merged, a, b) / (b - a) for a, b in spans if b > a],
        "device_ops": [[n[:NAME_CHARS], total[n] * 1e-6] for n, _ in
                       collections.Counter(total).most_common(top_n)],
        "idle_gaps": [[host_op_at(host, t), g * 1e-6] for g, t in gaps[:top_n]],
    }


def profile(fn: Callable[[], None]) -> dict:
    """Run fn() under the profiler (host and CUDA activities), read the
    trace back from a file under TMPDIR, delete it, and analyze it."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    fd, path = tempfile.mkstemp(suffix=".trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    events = data.get("traceEvents", data if isinstance(data, list) else [])
    return analyze(events)
