"""A device trace of the benchmark's worst-case frames (counterpart of
scripts/capture_trace.py):

    python3 -m faster_voxelpose_tpu_torch.tools.capture_trace [logdir] [F] [--device cpu] [--cfg YAML]
    python3 -m faster_voxelpose_tpu_torch.tools.analyze_trace <logdir> 15 --frames F

Runs the staged-frame pipeline of `tools/bench.py`'s worst case
(bench.py:33-165): configs/panoptic/jln64.yaml with MIN_SCORE -1 (all K =
10 proposal slots valid), the model and ResNet-50 seeded with 0, bench.py's
dome rig, F frames (default 8) of float32 5 x 512 x 960 x 3 images from
numpy's RandomState(0); each frame the backbone, then the full model,
chained by bench.py's carry.  The F frames are captured into one CUDA
graph (the counterpart of the script's jitted `lax.scan`), replayed once
to warm, then replayed once under `torch.profiler` (CPU and CUDA
activities); `tensorboard_trace_handler` writes the trace under `logdir`
(default build/trace, inside the checkout) as `<host>.<ns>.pt.trace.json.gz`.
The replay's kernels are in the trace by name (`whole_kernel`,
`crop_kernel<false, false>`, cuDNN's convolutions).  On the CPU (tests)
the F frames run eagerly under the CPU profiler.  Prints where the trace
went and, last, one JSON line with its path, F and the kernel launches of
the traced replay.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import pin_float32, resolve_device
from ..engine import graphs
from ..models import build_model
from ..models.resnet import build_backbone
from ..ops import sampling_kernels as sk
from . import analyze_trace
from .bench import WORST_CASE_CFG, bench_rig, frame_step, seeded, worst_case_config
from .timing import device_line, scan

REPO = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_LOGDIR = REPO / "build" / "trace"


def worst_case_frames(cfg, frames: int, device: torch.device):
    """bench.py's worst-case step and its F frames on `device`: (step,
    frames (F, V, ih, iw, 3))."""
    V = cfg.DATASET.CAMERA_NUM
    iw, ih = cfg.DATASET.IMAGE_SIZE
    model = seeded(build_model, cfg, 0, device)
    backbone = seeded(build_backbone, cfg, 0, device)
    cams = torch.as_tensor(bench_rig(cfg)).to(device)
    x = np.random.RandomState(0).randn(frames, V, ih, iw, 3).astype(np.float32)
    return frame_step(model, backbone, cams), torch.as_tensor(x).to(device)


def capture(logdir: str, frames: int, device: torch.device, cfg_path=WORST_CASE_CFG) -> dict:
    """Trace one run of F worst-case frames into `logdir`; returns the
    trace's path and the launches of the traced run."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    cfg = worst_case_config(cfg_path)
    step, x = worst_case_frames(cfg, frames, device)
    carry = torch.zeros((), device=device)
    run = lambda: scan(step, (x,), frames, carry)  # noqa: E731
    os.makedirs(logdir, exist_ok=True)
    handler = tensorboard_trace_handler(logdir, use_gzip=True)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        stream = torch.cuda.Stream(device)
        graphs.run_on(stream, run, inference=True)
        captured = graphs.capture(run, stream, inference=True)
        graphs.replay(captured)  # warm
        torch.cuda.synchronize(device)
        before = sk.launch_counts()
        with profile(activities=activities, on_trace_ready=handler):
            graphs.replay(captured)
            torch.cuda.synchronize(device)
        del captured
    else:
        with torch.inference_mode():
            run()  # warm
            before = sk.launch_counts()
            with profile(activities=activities, on_trace_ready=handler):
                run()
    return {"trace": analyze_trace.find_trace(logdir), "frames": frames,
            "launches": {k: n - before[k] for k, n in sk.launch_counts().items()}}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("logdir", nargs="?", default=str(DEFAULT_LOGDIR))
    p.add_argument("frames", nargs="?", type=int, default=8, help="F frames in the traced graph")
    p.add_argument("--device", default=None, help="default: the CUDA device (cpu: tests only)")
    p.add_argument("--cfg", default=str(WORST_CASE_CFG), help="the worst case's config")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    pin_float32()
    res = capture(args.logdir, args.frames, device, args.cfg)
    print(f"trace written under {args.logdir} (F={args.frames} frames): {res['trace']} | "
          f"{device_line(device)}")
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
