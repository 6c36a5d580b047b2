#!/usr/bin/env python3
"""Where the time of one served request, or of one train step, goes on
one NVIDIA GPU.

    python3 chip_profile.py [--requests N]
    python3 chip_profile.py --images [--requests N]
    python3 chip_profile.py --train [--steps N]

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
phase; the batches are moved to the card before the timed window, so
the window holds the steps alone.  Prints the card, the host wall time
per request or step (each ends in a synchronisation), the device time
and its share of the untraced wall time, the device events, the launches
of kernel row 1 (the whole-space sampler, either mode) by the launch
counters, the kernels of rows 1 and 2 by name in the trace
(`whole_kernel`, `crop_kernel`) per request or step, then the kernels
with the most device time.  Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import json
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


def train_profile(args, card) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from faster_voxelpose_tpu_torch.config import panoptic_synthetic_profile
    from faster_voxelpose_tpu_torch.engine.trainer import Trainer, batch_to_device
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    cfg = panoptic_synthetic_profile()
    n = args.steps
    batches = [batch_to_device(b, "cuda") for b in cs.synthetic_loader(cfg, 3 + 2 * n)]
    torch.manual_seed(0)
    tr = Trainer(cfg, build_model(cfg).cuda())
    for b in batches[:3]:
        tr.step(b)
    torch.cuda.synchronize()

    def steps(bs):
        t0 = time.perf_counter()
        for b in bs:
            tr.step(b)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / len(bs)

    wall_ms = steps(batches[3:3 + n])
    sk.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_ms = steps(batches[3 + n:])
    report(prof, n, wall_ms, traced_ms, card, "step", args.top, sk.launch_counts(),
           f" of batch {cfg.TRAIN.BATCH_SIZE}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--images", action="store_true",
                    help="image requests (backbone included), not heatmap requests")
    ap.add_argument("--train", action="store_true", help="profile train steps, not requests")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--top", type=int, default=15)
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
