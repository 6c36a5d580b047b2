"""Where a traced run's device time goes (counterpart of
scripts/analyze_trace.py):

    python3 -m faster_voxelpose_tpu_torch.tools.analyze_trace <logdir-or-trace> [top_n] [--frames F]

Reads a `torch.profiler` Chrome trace: the `.pt.trace.json[.gz]` that
`tensorboard_trace_handler` writes (`tools/capture_trace.py` does), or a
file of `export_chrome_trace`.  Given a directory it takes the newest
`*.trace.json[.gz]` under it, as the script does.  It sums `dur` per name
over the device's events (`cat` "kernel", "gpu_memcpy" and "gpu_memset":
the kernels of a replayed CUDA graph appear there by name) and prints the
script's top-N table (name, total ms, count, %) and the sum of durations
over the span.  Two readings that the TPU trace did not give are added:

- the busy share: the union of the device intervals over the span from
  the first device event's start to the last one's end (kernels on two
  streams that overlap count once);
- the longest idle gaps in that union, each with the host operator that
  was running at its start (the innermost `cpu_op`, `cuda_runtime`,
  `cuda_driver` or `user_annotation` event holding that instant).

With `--frames F` each total is also divided by F (ms per frame).  Where
the trace has no device event (a CPU run), every complete event is read,
as the script's fallback does; the header then says "host" and names the
lanes read, since nested host events overlap and their sum is no device
time.  The script's thread filter ("XLA Ops" lanes, `jit` envelopes) is a
property of XLA's traces and has no counterpart.  The last line is one
JSON object of the readings.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import sys
from typing import Dict, List, Optional, Sequence

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def find_trace(path: str) -> str:
    """`path` if it is a file, else the newest trace file under it."""
    if os.path.isfile(path):
        return path
    pats = [
        os.path.join(path, "**", "*.trace.json.gz"),
        os.path.join(path, "**", "*.trace.json"),
    ]
    files = [f for p in pats for f in glob.glob(p, recursive=True)]
    if not files:
        raise SystemExit(f"no trace.json[.gz] under {path}")
    return max(files, key=os.path.getmtime)


def load_events(path: str) -> List[dict]:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as fh:
        data = json.load(fh)
    return data.get("traceEvents", data if isinstance(data, list) else [])


def _lane_names(events: List[dict]):
    """{(pid, tid): "process / thread"} and {pid: process} from the
    trace's metadata events."""
    procs, threads = {}, {}
    for e in events:
        if e.get("ph") != "M":
            continue
        name = str(e.get("args", {}).get("name", ""))
        if e.get("name") == "process_name":
            procs[e.get("pid")] = name
        elif e.get("name") == "thread_name":
            threads[(e.get("pid"), e.get("tid"))] = name
    return {(pid, tid): f"{procs.get(pid, pid)} / {name}"
            for (pid, tid), name in threads.items()}, procs


def union(intervals: List[tuple]) -> List[tuple]:
    """Sorted, merged (start, end) intervals."""
    merged: List[list] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return [tuple(m) for m in merged]


def host_op_at(host: List[dict], t: float) -> str:
    """The innermost host event running at time t (us), or "(none)"."""
    best = None
    for e in host:
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if ts <= t < ts + dur and (best is None or ts > float(best["ts"])
                                   or (ts == float(best["ts"]) and dur < float(best["dur"]))):
            best = e
    return "(none)" if best is None else str(best.get("name", "?"))


def analyze(events: List[dict], top_n: int = 40, gaps: int = 3) -> dict:
    """The readings of a trace's events: kind ("device" or "host"), the
    lanes read, per-name totals (us) and counts, their sum, the span, the
    busy share and the longest idle gaps (us) with the host op at each."""
    complete = [e for e in events if e.get("ph") == "X"]
    dev = [e for e in complete if e.get("cat") in DEVICE_CATS]
    kind = "device" if dev else "host"
    read = dev if dev else complete
    lanes, procs = _lane_names(events)
    lane_ids = sorted({(e.get("pid"), e.get("tid")) for e in read}, key=str)
    total: Dict[str, float] = collections.Counter()
    count: Dict[str, int] = collections.Counter()
    spans = []
    for e in read:
        name = e.get("name", "?")
        dur = float(e.get("dur", 0.0))  # microseconds
        total[name] += dur
        count[name] += 1
        ts = float(e.get("ts", 0.0))
        spans.append((ts, ts + dur))
    merged = union(spans)
    lo = merged[0][0] if merged else 0.0
    hi = merged[-1][1] if merged else 0.0
    span = max(hi - lo, 1e-9)
    busy = sum(b - a for a, b in merged)
    host = [e for e in complete if e.get("cat") in HOST_CATS and "ts" in e and "dur" in e]
    idle = sorted(((b[0] - a[1], a[1]) for a, b in zip(merged, merged[1:])), reverse=True)
    return {
        "kind": kind,
        "lanes": [lanes.get(k, f"{procs.get(k[0], k[0])} / {k[1]}") for k in lane_ids],
        "total_us": dict(total),
        "count": dict(count),
        "top": [(n, total[n], count[n]) for n, _ in collections.Counter(total).most_common(top_n)],
        "sum_us": float(sum(total.values())),
        "span_us": float(span),
        "busy_us": float(busy),
        "busy_share": float(busy / span),
        "gaps": [(float(g), float(t - lo), host_op_at(host, t)) for g, t in idle[:gaps]],
    }


def report(res: dict, path: str, frames: Optional[int] = None) -> None:
    """Print the readings as the script prints its table."""
    grand = max(res["sum_us"], 1e-9)
    per = f", {res['sum_us'] / 1e3 / frames:.4f} ms a frame over {frames}" if frames else ""
    print(f"trace: {path}")
    if res["kind"] == "device":
        print(f"device lanes read (cat {', '.join(DEVICE_CATS)}): {res['lanes']}")
    else:
        print(f"host: no device event in the trace; every complete event read, on the lanes "
              f"{res['lanes']} (nested host events overlap: this sum is no device time)")
    print(f"sum of {res['kind']} op durations: {res['sum_us'] / 1e3:.2f} ms over a "
          f"{res['span_us'] / 1e3:.2f} ms span{per}; busy share {res['busy_share']:.4f} "
          f"(union of the {res['kind']} intervals over the span)\n")
    print(f"{'op':<72} {'total ms':>9} {'n':>6} {'%':>6}")
    for name, dur, n in res["top"]:
        print(f"{name[:72]:<72} {dur/1e3:9.3f} {n:6d} {100*dur/grand:5.1f}%")
    print(f"\nlongest idle gaps of the {res['kind']} ({len(res['gaps'])}):")
    for gap, at, op in res["gaps"]:
        print(f"  {gap / 1e3:9.4f} ms at +{at / 1e3:.4f} ms, host op at its start: {op[:80]}")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("path", nargs="?", default=os.path.join("build", "trace"),
                   help="a trace file or a directory holding traces (default build/trace)")
    p.add_argument("top_n", nargs="?", type=int, default=40)
    p.add_argument("--frames", type=int, default=None, help="divide the totals by F frames")
    args = p.parse_args(argv)
    path = find_trace(args.path)
    res = analyze(load_events(path), args.top_n)
    report(res, path, args.frames)
    summary = {k: res[k] for k in ("kind", "lanes", "sum_us", "span_us", "busy_share", "gaps")}
    summary.update(trace=path, frames=args.frames,
                   top=[{"name": n, "ms": d / 1e3, "n": c} for n, d, c in res["top"]])
    print(json.dumps(summary))
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
