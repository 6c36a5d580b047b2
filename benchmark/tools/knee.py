"""The knee of a live cell: the highest rate at which the service keeps up,
found once by a sweep on the card:

    python3 -m benchmark.tools.knee <cell> <seconds> <rate> [<rate> ...]

One set-up, then for each rate one open-loop window of the cell's
traffic (`drivers/live_service.py`).  Per rate: the share of due requests
answered within the window, the mean queue wait of the window's first
and last quarters (a growing backlog shows as the last above the first),
and latency p50 / p95.  A rate keeps up where at least 99% are answered
in the window and the last quarter waits no more than the first plus one
period.
"""

from __future__ import annotations

import gc
import json
import sys
import time

import numpy as np
import torch

from benchmark.core.spec import load_cell
from benchmark.drivers import live_service as live
from benchmark.run import ROOT
from benchmark.traffic.generate import make_traffic


def sweep(cell_name: str, seconds: float, rates, seed: int = 7, device=None) -> list:
    device = device or torch.device("cuda", 0)
    cell = load_cell(cell_name)
    arrays = live.load_arrays(ROOT / cell.config["weights"])
    traffic = make_traffic(cell.mix, cell.config, rates[0], seconds, seed, device)
    svc, _ = live.build_service(cell, traffic, arrays, seed, device)
    call = getattr(svc, cell.workload["method"])
    for x in traffic.pool[:8]:
        call(x)
    rows = []
    for rate in rates:
        tr = make_traffic(cell.mix, cell.config, rate, seconds, seed, device)
        gc.collect()
        gc.disable()
        t0 = time.perf_counter() + 0.01
        reqs, _ = live.serve(call, tr, tr.order, tr.due, t0, t0 + seconds)
        gc.enable()
        done = [r for r in reqs if r.ok and r.done <= t0 + seconds]
        q = len(reqs) // 4
        wait = np.array([r.entered - r.due for r in reqs]) * 1e3
        lat = np.array([r.done - r.due for r in reqs]) * 1e3
        row = {"rate": rate, "due": len(tr.due), "answered_in_window": len(done) / len(tr.due),
               "wait_first_q_ms": float(wait[:q].mean()), "wait_last_q_ms": float(wait[-q:].mean()),
               "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95))}
        row["keeps_up"] = bool(row["answered_in_window"] >= 0.99 and
                               row["wait_last_q_ms"] <= row["wait_first_q_ms"] + 1e3 / rate)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    a = sys.argv[1:]
    sweep(a[0], float(a[1]), [float(r) for r in a[2:]])
