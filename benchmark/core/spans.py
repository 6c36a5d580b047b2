"""The program's own span log (`faster_voxelpose_tpu_torch.utils.
profiling.SPANS`), read for the timed window: the requests whose
`service.request` span lies between the window's first call into the
service and its last answer (`run.requests`, on the same perf_counter
clock), so that warm requests and a traced segment after the window are
left out; and the set-up spans of the service that served the window.

Every function returns None where there is nothing to read: no window,
no request of the log inside it, or a program without the log."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

# the columns of the log's arrays, by name (the program's REQUEST_SPANS,
# DEVICE_INTERVALS, COUNTERS)
STAMPS = ("service.request", "service.input", "service.upload", "service.launch",
          "service.wait", "service.decode")
DEVICE = ("device.upload", "device.launch_gap", "device.backbone", "device.hdn", "device.jln")
COUNTERS = ("jln.slots", "jln.people")


def log():
    """The program's span log, or None where the program has none."""
    try:
        from faster_voxelpose_tpu_torch.utils import profiling
    except ImportError:
        return None
    return getattr(profiling, "SPANS", None)


def window(run) -> Optional[Dict[str, np.ndarray]]:
    """The log's requests inside the run's timed window: "owner",
    "stamps_ns" (n, 6), "device_ms" (n, 5), "counters" (n, 2)."""
    spans = log()
    if spans is None or not run.requests:
        return None
    rows = spans.requests()
    lo, hi = run.requests[0].entered * 1e9, run.requests[-1].done * 1e9
    st = rows["stamps_ns"]
    keep = (st[:, 0] >= lo) & (st[:, -1] <= hi)
    if not keep.any():
        return None
    return {k: v[keep] for k, v in rows.items()}


def child_ms(w, *names: str) -> np.ndarray:
    """Per request, the summed ms of the named child spans."""
    st = w["stamps_ns"]
    total = np.zeros(len(st))
    for n in names:
        k = STAMPS.index(n)
        total += (st[:, k] - st[:, k - 1]) * 1e-6
    return total


def p50(values) -> Optional[float]:
    v = np.asarray(values, np.float64)
    v = v[np.isfinite(v)]
    return float(np.percentile(v, 50)) if v.size else None


def device_p50(run, name: str) -> Optional[float]:
    """p50 over the window's requests of one device interval, ms."""
    w = window(run)
    return None if w is None else p50(w["device_ms"][:, DEVICE.index(name)])


def setup_spans(run, name: str) -> List[float]:
    """Seconds of each set-up span `name` of the service that served the
    window."""
    w = window(run)
    spans = log()
    if w is None:
        return []
    owners = set(w["owner"].tolist())
    return [(s["end_ns"] - s["start_ns"]) * 1e-9 for s in spans.setup_spans()
            if s["name"] == name and s["owner"] in owners]
