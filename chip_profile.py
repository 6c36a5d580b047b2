#!/usr/bin/env python3
"""Where the time of one served request goes, on one NVIDIA GPU.

    python3 chip_profile.py [--requests N]

Serves frames rendered as in chip_smoke.py's serving phase (PoseService,
Panoptic profile, committed panoptic_synthetic weights) and times N
requests untraced, then traces them with torch.profiler.  Prints the
card, the host wall time per request (each request ends with its poses
on the host), the device time per request and its share of the
untraced wall time, then the kernels with the most device time.  Needs
a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from faster_voxelpose_tpu_torch.config import panoptic_synthetic_profile
    from faster_voxelpose_tpu_torch.engine import PoseService
    from faster_voxelpose_tpu_torch.geometry import dome_rig

    card = cs.card_line()
    cfg = panoptic_synthetic_profile()
    center = cfg.CAPTURE_SPEC.SPACE_CENTER
    rig = dome_rig(1, cfg.DATASET.CAMERA_NUM, space_center=center)[0]
    with np.load(cs.ROOT / "checkpoints/panoptic_synthetic/model_best.npz") as npz:
        variables = {k: npz[k] for k in npz.files}
    svc = PoseService(cfg, variables=variables, rig=rig, device="cuda")
    svc.warmup()
    rng = np.random.RandomState(1)
    frames = [cs.render_frame(cs.make_people(rng, int(rng.randint(1, 7)), center), rig, cfg,
                              svc.device) for _ in range(args.requests)]
    for f in frames[:3]:
        svc.infer_heatmaps(f)
    torch.cuda.synchronize()

    # the same requests untraced, then traced: the tracer slows the host
    t0 = time.perf_counter()
    for f in frames:
        svc.infer_heatmaps(f)
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.requests
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        detected = [svc.infer_heatmaps(f)["n_people"] for f in frames]
        traced_ms = (time.perf_counter() - t0) * 1e3 / args.requests

    # device-side events only (kernels, copies, fills): the host operators
    # that launched them carry the same time again
    rows = [(e.key, e.self_device_time_total / 1e3 / args.requests, e.count // args.requests)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    if device_ms <= 0:
        raise AssertionError("the trace holds no device time")
    print(f"profile: {args.requests} requests, mean detected {np.mean(detected):.3f} | {card}")
    print(f"profile: host wall {wall_ms:.4f} ms/request untraced ({traced_ms:.4f} traced), "
          f"device {device_ms:.4f} ms/request, busy share {device_ms / wall_ms:.4f}")
    for name, ms, count in rows[:args.top]:
        print(f"  {ms:9.4f} ms {ms / device_ms:7.2%} x{count:<4d} {name[:90]}")
    print(json.dumps({"wall_ms": wall_ms, "traced_ms": traced_ms, "device_ms": device_ms,
                      "top": [dict(name=n[:90], ms=m, launches=c) for n, m, c in rows[:args.top]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
