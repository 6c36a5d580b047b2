#!/usr/bin/env python3
"""Where the time of one served request, or of one train step, goes on
one NVIDIA GPU.

    python3 chip_profile.py [--requests N]
    python3 chip_profile.py --images [--requests N]
    python3 chip_profile.py --train [--steps N]
    python3 chip_profile.py [--images] --chrome-trace build/trace/serve

Serving: frames rendered as in chip_smoke.py's serving phase
(Panoptic profile, committed panoptic_synthetic weights), answered in
one run by an eager PoseService (`aot=False`) and by a compiled one (its
CUDA graphs), the same requests in turn; for each, N requests are timed
untraced, then traced with torch.profiler.  With --images the requests
are images, as in chip_smoke.py's images phase: 5 uint8 frames of
960x512 (uniform noise from a seed) through a seeded random ResNet-50
backbone, normalised on the card (`infer_images`, the 'images_u8'
graph).  Training (--train): train steps at the Panoptic profile (bf16
conv stacks, batch 4, seeded random weights) on synthetic scenes from the
port's generator, rendered on the card, as in chip_smoke.py's training
phase, by an eager and a compiled trainer (its step a CUDA graph) in one
run; the batches are moved to the card before the timed window, so the
window holds the steps alone.  Prints the card, the host wall time
per request or step (each ends in a synchronisation), the device time
and its share of the untraced wall time, the device events, the launches
of kernel row 1 (the whole-space sampler, either mode) by the launch
counters, the kernels of rows 1 and 2 by name in the trace
(`whole_kernel`, `crop_kernel`) per request or step, then the kernels
with the most device time.  With --chrome-trace PREFIX each served
trace is also written as PREFIX.<service>.json, and the longest device
idle gaps inside the traced requests are printed with the service span
(`service.input`, `.upload`, `.launch`, `.wait`, `.decode`, from the
port's span log) that covers each.  Needs a CUDA device; fails without
one.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

import numpy as np


def report(prof, n, wall_ms, traced_ms, card, unit, top, launches, extra=""):
    """Print the device time per `unit` by kernel from a torch.profiler
    trace of n units, beside the untraced host wall time; `launches` are
    the kernels' launch counters over the traced units."""
    from torch.autograd import DeviceType

    # device-side events only (kernels, copies, fills): the host operators
    # that launched them carry the same time again, and so do annotated
    # ranges such as the optimizer's step on the device's timeline
    rows = [(e.key, e.self_device_time_total / 1e3 / n, e.count // n)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    if device_ms <= 0:
        raise AssertionError("the trace holds no device time")
    events = sum(r[2] for r in rows)
    row1 = {k: launches[k] / n for k in ("sample_whole", "sample_whole_projected")}
    row1_ms = sum(ms for name, ms, _ in rows if "whole_kernel" in name)
    by_name = {k: sum(c for name, _, c in rows if k in name)
               for k in ("whole_kernel", "crop_kernel")}
    print(f"profile: {n} {unit}s{extra} | {card}")
    print(f"profile: host wall {wall_ms:.4f} ms/{unit} untraced ({traced_ms:.4f} traced), "
          f"device {device_ms:.4f} ms/{unit}, busy share {device_ms / wall_ms:.4f}, "
          f"{events} device events/{unit}; kernel row 1 launches/{unit} {row1}, its device "
          f"time {row1_ms:.4f} ms/{unit}; rows 1 and 2 by name in the trace, per {unit}: "
          f"{by_name}")
    for name, ms, count in rows[:top]:
        print(f"  {ms:9.4f} ms {ms / device_ms:7.2%} x{count:<4d} {name[:90]}")
    print(json.dumps({"unit": unit, "extra": extra.strip(", "), "wall_ms": wall_ms,
                      "traced_ms": traced_ms, "device_ms": device_ms, "device_events": events,
                      "row1_launches": row1, "row1_ms": row1_ms, "by_name": by_name,
                      "top": [dict(name=n_[:90], ms=m, launches=c) for n_, m, c in rows[:top]]}))


def spans_over_gaps(events, top: int = 5):
    """The `top` longest gaps between the device's busy intervals inside
    a `service.request` span of a Chrome trace's events, longest first:
    (gap us, start us, the service span over most of the gap, its share
    of the gap)."""
    done = [e for e in events if e.get("ph") == "X" and "dur" in e]
    busy = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in done
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in done
             if e.get("cat") == "user_annotation" and e["name"].startswith("service.")]
    requests = [(a, b) for n, a, b in spans if n == "service.request"]
    merged = []
    for lo, hi in busy:
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:])
            if any(r0 <= a[1] and b[0] <= r1 for r0, r1 in requests)]
    out = []
    for g, lo, hi in sorted(gaps, reverse=True)[:top]:
        cover = collections.Counter()
        for n, a, b in spans:
            if n != "service.request":
                cover[n] += max(0.0, min(b, hi) - max(a, lo))
        name = max(cover, key=cover.get) if cover else "(none)"
        out.append((g, lo, name, cover.get(name, 0.0) / g if g > 0 else 0.0))
    return out


def serve_profile(args, card) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from faster_voxelpose_tpu_torch.config import panoptic_synthetic_profile
    from faster_voxelpose_tpu_torch.engine import PoseService
    from faster_voxelpose_tpu_torch.geometry import dome_rig
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    cfg = panoptic_synthetic_profile()
    center = cfg.CAPTURE_SPEC.SPACE_CENTER
    rig = dome_rig(1, cfg.DATASET.CAMERA_NUM, space_center=center)[0]
    with np.load(cs.ROOT / "checkpoints/panoptic_synthetic/model_best.npz") as npz:
        variables = {k: npz[k] for k in npz.files}
    services = {"eager": PoseService(cfg, variables=variables, rig=rig, device="cuda",
                                     aot=False),
                "compiled": PoseService(cfg, variables=variables, rig=rig, device="cuda")}
    rng = np.random.RandomState(1)
    if args.images:
        services["compiled"].warmup(("images_u8",))
        iw, ih = cfg.DATASET.IMAGE_SIZE
        frames = [rng.randint(0, 256, (cfg.DATASET.CAMERA_NUM, ih, iw, 3)).astype(np.uint8)
                  for _ in range(args.requests)]
        what = f", uint8 frames {iw}x{ih}, random ResNet-50 backbone"
    else:
        frames = [cs.render_frame(cs.make_people(rng, int(rng.randint(1, 7)), center), rig, cfg,
                                  "cuda") for _ in range(args.requests)]
        what = ""
    for name, svc in services.items():
        infer = svc.infer_images if args.images else svc.infer_heatmaps
        for f in frames[:3]:
            infer(f)
        torch.cuda.synchronize()

        # the same requests untraced, then traced: the tracer slows the host
        t0 = time.perf_counter()
        for f in frames:
            infer(f)
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.requests
        sk.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            detected = [infer(f)["n_people"] for f in frames]
            traced_ms = (time.perf_counter() - t0) * 1e3 / args.requests
        report(prof, args.requests, wall_ms, traced_ms, card, "request", args.top,
               sk.launch_counts(), f"{what}, {name} service (compiled graphs "
               f"{svc.stats()['compiled']}), mean detected {np.mean(detected):.3f}")
        if args.chrome_trace:
            path = f"{args.chrome_trace}.{name}.json"
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
            for gap, ts, span, share in spans_over_gaps(events):
                print(f"  idle gap {gap:8.1f} us at {ts:.1f} us under {span} ({share:.0%} "
                      f"of the gap) [{name}, {path}]")


def train_profile(args, card) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from faster_voxelpose_tpu_torch.config import panoptic_synthetic_profile
    from faster_voxelpose_tpu_torch.engine.graphs import CAPTURE_WARMUP
    from faster_voxelpose_tpu_torch.engine.trainer import Trainer, batch_to_device
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    cfg = panoptic_synthetic_profile()
    n, warm = args.steps, CAPTURE_WARMUP + 1
    batches = [batch_to_device(b, "cuda") for b in cs.synthetic_loader(cfg, warm + 2 * n)]
    for compiled in (False, True):
        torch.manual_seed(0)
        tr = Trainer(cfg, build_model(cfg).cuda(), compiled=compiled)
        for b in batches[:warm]:  # the compiled trainer's warm-up and capture
            tr.step(b)
        torch.cuda.synchronize()

        def steps(bs):
            t0 = time.perf_counter()
            for b in bs:
                tr.step(b)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / len(bs)

        wall_ms = steps(batches[warm:warm + n])
        sk.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced_ms = steps(batches[warm + n:])
        report(prof, n, wall_ms, traced_ms, card, "step", args.top, sk.launch_counts(),
               f" of batch {cfg.TRAIN.BATCH_SIZE}, {'compiled' if compiled else 'eager'} trainer")
        del tr


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--images", action="store_true",
                    help="image requests (backbone included), not heatmap requests")
    ap.add_argument("--train", action="store_true", help="profile train steps, not requests")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--chrome-trace", default=None, metavar="PREFIX",
                    help="write each served trace to PREFIX.<service>.json and name the "
                         "span over each of its longest idle gaps")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    from faster_voxelpose_tpu_torch.tools.timing import card_line

    card = card_line()
    (train_profile if args.train else serve_profile)(args, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
