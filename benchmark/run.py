"""Run one cell of the benchmark once and print its result line:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's files are found by name
(`core/spec.py`); its driver sets up the port, serves the window, and
checks the answers against the plain reference.  With --trace 0 the
line's metrics are the cell's end-to-end metrics, with --trace 1 its
per-layer metrics, read by `metrics/<name>.py`.  The last lines on
standard error are the numbers compared, each with its limit; the last
line on standard output is the JSON result.

Exits non-zero and prints no result where the card is missing or the
cell asks for more cards than there are, and where the JAX package or
JAX was loaded by the time the window closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# build and kernel caches at fixed paths inside the checkout, so that only
# a checkout's first run builds; the port builds its own kernels into
# build/kernels/ beside them
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ.setdefault("OMP_NUM_THREADS", "2")
os.environ["USE_FLAX"] = "0"
# the checkout's root on the path, and not this folder (run as a script,
# Python puts it first), whose package names are the benchmark's own
sys.path[:] = [p for p in sys.path if pathlib.Path(p or ".").resolve() != ROOT / "benchmark"]
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "faster_voxelpose_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Context:
    cell: object
    seed: int
    seconds: float
    trace: bool
    device: object
    root: pathlib.Path
    t_start: float
    chips: int = 1

    def device_info(self) -> dict:
        import torch

        if self.device.type != "cuda":
            return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(self.device),
                "count": self.chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(self.device))}


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float):
    """Drive the cell once; returns (result dict, checks {name: (value,
    limit)})."""
    from benchmark.core.spec import read_metrics

    ctx = Context(cell, seed, seconds, trace, device, ROOT, t_start,
                  int(cell.workload.get("chips", 1)))
    record, checks, device_info = cell.driver.run(ctx)
    correct = record.failed == 0 and all(v <= lim for v, lim in checks.values())
    result = {"correct": bool(correct), "attempted": record.attempted, "failed": record.failed,
              "metrics": read_metrics(cell, record, end_to_end=not trace),
              "device": device_info}
    if trace and record.trace:
        result["device"]["busy_s"] = record.trace["busy_s"]
        result["device"]["window_s"] = record.trace["window_s"]
        result["breakdown"] = {"device_ops": record.trace["device_ops"],
                               "idle_gaps": record.trace["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.core.spec import load_cell

    cell = load_cell(args.workload)
    import torch

    torch.set_num_threads(2)
    chips = int(cell.workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded by the time the window closed: {bad}", file=sys.stderr)
        return 3
    result["device"]["power"] = power_limit()
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
