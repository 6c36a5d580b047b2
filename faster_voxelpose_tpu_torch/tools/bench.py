"""End-to-end benchmark of the port on the card (counterpart of the JAX
package's bench.py):

    python3 -m faster_voxelpose_tpu_torch.tools.bench
    BENCH_THROUGHPUT_BATCH=4 python3 -m faster_voxelpose_tpu_torch.tools.bench

Prints the card's name and power limit, the peak device memory allocated,
the kernel launches of the run, then one JSON line with bench.py's keys
(`panoptic_5view_e2e_fps_per_chip`) and the device's time beside each
rate.

**Worst case** (`bench.py:33-165`): configs/panoptic/jln64.yaml with
CAPTURE_SPEC.MIN_SCORE -1, so that every one of the K proposal slots goes
through the JLN; a model and a ResNet-50 backbone drawn from torch's
generator seeded with 0; a 5-camera dome rig; float32 frames of
5 x 512 x 960 x 3 drawn by numpy's RandomState(0) in bench.py's order.
The whole pipeline runs per frame: the backbone over the views,
whole-space projection, HDN and JLN.  *Latency*: one frame per step, the
per-frame time the slope between 2 and 12 steps.  *Throughput*:
BENCH_THROUGHPUT_BATCH frames (8) per step, the backbone over all their
views as one batch, the slope between 1 and 4 steps.

**Realistic load** (`bench.py:168-346`): the committed
checkpoints/panoptic_synthetic weights at their own MIN_SCORE (0.1) on the
first 24 held-out synthetic scenes of configs/demo/panoptic_synthetic.yaml
(heatmaps rendered on the host, the scenes made from their seeds in
memory: `tools.validate.held_out_dataset`).  Fusion alone (heatmaps ->
poses) per frame (3 and 18 steps) and per batch (1 and 4 steps), and the
whole pipeline, a random ResNet-50 (seed 1) over five 512 x 960 images
folded into the heatmaps at 1e-30, per frame (2 and 10) and per batch
(1 and 4).

Every measurement is `tools.timing.scan_slope`: F steps chained by a
scalar carry (1e-30 of one output, added to the next step's input, as
bench.py does) in one CUDA graph, replayed 3 times; the least host time
up to the outputs on the host and the least device time between two
events, each differenced between the two lengths.  The rates that carry
bench.py's names are from the host's clock, as bench.py's; the
`*_device_ms` keys are the device's ms per step.  The run is as served:
bf16 conv stacks, float32 with TF32 off.

Two departures from bench.py: `realistic_detected_people` is averaged
over the same 24 frames as `realistic_true_people` (bench.py takes the
first 8), and a failure of the realistic part raises (bench.py reports it
in `realistic_error` and exits 0).  The run holds the bench lock
(`utils.bench_lock`), so that training in the checkout pauses.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import pathlib
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..config import Config, load_config
from ..device import pin_float32, resolve_device
from ..geometry import dome_rig
from ..models import build_model
from ..models.resnet import build_backbone
from ..ops import sampling_kernels as sk
from .timing import Slope, device_line, scan_slope

REPO = pathlib.Path(__file__).resolve().parents[2]
WORST_CASE_CFG = REPO / "configs" / "panoptic" / "jln64.yaml"
REALISTIC_CFG = REPO / "configs" / "demo" / "panoptic_synthetic.yaml"
SNAPSHOT = REPO / "checkpoints" / "panoptic_synthetic" / "model_best.npz"

METRIC = "panoptic_5view_e2e_fps_per_chip"
BASELINE_FPS = 31.0  # bench.py's: paper-class single-GPU "real-time" throughput
# bench.py's scan lengths, (F1, F2) per mode
LENGTHS = {"latency": (2, 12), "throughput": (1, 4), "fusion": (3, 18),
           "fusion_batched": (1, 4), "e2e": (2, 10), "e2e_batched": (1, 4)}
REALISTIC_FRAMES = 24
REALISTIC_NOTE = (
    "trained committed checkpoint (checkpoints/panoptic_synthetic) at default MIN_SCORE on "
    "held-out synthetic scenes; e2e includes ResNet-50 over five 512x960 views (timing-only "
    "random-init backbone: no backbone weights are committed), fusion-only is the reference's "
    "precomputed-heatmap mode; detected and true people averaged over the same 24 frames"
)
# the keys of bench.py's line, in its order, and the port's device time
# beside each rate
HEADLINE_KEYS = ("metric", "value", "unit", "vs_baseline", "throughput_fps", "throughput_batch")
REALISTIC_KEYS = ("realistic_e2e_fps", "realistic_e2e_fps_batched", "realistic_fusion_fps",
                  "realistic_fusion_fps_batched", "realistic_batch", "realistic_true_people",
                  "realistic_detected_people", "realistic_min_score", "realistic_note")
DEVICE_KEYS = ("latency_device_ms", "throughput_device_ms", "realistic_fusion_device_ms",
               "realistic_fusion_batched_device_ms", "realistic_e2e_device_ms",
               "realistic_e2e_batched_device_ms")
RATE_KEYS = ("value", "throughput_fps", "realistic_e2e_fps", "realistic_e2e_fps_batched",
             "realistic_fusion_fps", "realistic_fusion_fps_batched")


def seeded(build, cfg: Config, seed: int, device: torch.device) -> torch.nn.Module:
    """`build(cfg)` with its random weights drawn from torch's generator
    seeded with `seed` (the caller's generator state kept), on `device`."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build(cfg).to(device)


def worst_case_config(path=WORST_CASE_CFG) -> Config:
    """The worst case's config: every proposal slot valid."""
    cfg = load_config(path)
    cfg.CAPTURE_SPEC.MIN_SCORE = -1.0
    return cfg


def bench_rig(cfg: Config) -> np.ndarray:
    """bench.py's (1, V, 21) dome rig around the capture space."""
    return dome_rig(1, cfg.DATASET.CAMERA_NUM, space_center=cfg.CAPTURE_SPEC.SPACE_CENTER,
                    ori_image_size=cfg.DATASET.ORI_IMAGE_SIZE)


# -- the steps (bench.py's scan bodies) ------------------------------------


def frame_step(model, backbone, cams: torch.Tensor):
    """bench.py's frame_fn: one frame (V, ih, iw, 3) -> fused poses
    (K, J, 5); the carry is 1e-30 of the first pose's x."""

    def step(carry, x):
        (images,) = x
        hm = backbone(images + carry)
        fused = model(hm[None], cams).fused_poses[0]
        return fused[0, 0, 0] * 1e-30, fused

    return step


def batched_frame_step(model, backbone, cams: torch.Tensor):
    """bench.py's batched_frame_fn: B frames (B, V, ih, iw, 3) -> (B, K, J,
    5); the backbone sees the B * V images as one batch, the rig is
    broadcast over the batch."""

    def step(carry, x):
        (images,) = x
        B, V = images.shape[:2]
        hm = backbone(images.reshape(B * V, *images.shape[2:]) + carry)
        fused = model(hm.reshape(B, V, *hm.shape[1:]), cams.expand(B, -1, -1)).fused_poses
        return fused[0, 0, 0, 0] * 1e-30, fused

    return step


def summed(make_step):
    """bench.py's realistic scan body around `make_step(carry, x) -> fused
    poses`: 1e-30 of the sum of their x is the carry and the output."""

    def step(carry, x):
        ss = make_step(carry, x)[..., :1].sum() * 1e-30
        return ss, ss

    return step


def fusion_step(model):
    """bench.py's fusion_step: one frame's heatmaps (V, H, W, J) and rig
    (V, 21) plus 1e-30 of the carry -> fused poses (1, K, J, 5)."""
    return lambda c, x: model(x[0][None] + c * 1e-30, x[1][None]).fused_poses


def fusion_step_batched(model):
    """bench.py's fusion_step_b: a batch's heatmaps (B, V, H, W, J) and
    rigs (B, V, 21) -> fused poses (B, K, J, 5)."""
    return lambda c, x: model(x[0] + c * 1e-30, x[1]).fused_poses


def e2e_step(model, backbone):
    """bench.py's e2e_step: one frame's heatmaps, rig and images (V, ih,
    iw, 3); the backbone's heatmaps of the images plus the carry are
    folded into the frame's at 1e-30, so that the backbone's cost is paid
    in the chain while the detections stay the frame's."""

    def fused(c, x):
        hm, cam, img = x
        bb = backbone(img + c)
        return model(hm[None] + bb[None] * 1e-30, cam[None]).fused_poses

    return fused


def e2e_step_batched(model, backbone):
    """bench.py's e2e_step_b: `e2e_step` over a batch, the backbone over
    its B * V images at once."""

    def fused(c, x):
        hm, cam, img = x
        B, V = img.shape[:2]
        bb = backbone(img.reshape(B * V, *img.shape[2:]) + c)
        return model(hm + bb.reshape(B, V, *bb.shape[1:]) * 1e-30, cam).fused_poses

    return fused


def staged(arrays: Sequence[np.ndarray], device: torch.device):
    """`inputs(F)` for `scan_slope`: each array cycled to F steps along its
    first axis (np.resize, as bench.py's realistic runs), on `device`."""
    return lambda F: tuple(torch.as_tensor(np.resize(a, (F,) + a.shape[1:])).to(device)
                           for a in arrays)


# -- the two loads -----------------------------------------------------------


def valid_slots(fused: torch.Tensor) -> torch.Tensor:
    """The valid proposal slots per frame of fused poses (..., K, J, 5)."""
    return (fused[..., 0, 3] >= 0).sum(-1)


def worst_case(cfg: Config, device: torch.device, lengths=LENGTHS, batch: int = 8) -> dict:
    """Latency and throughput of the whole pipeline with every slot valid."""
    V = cfg.DATASET.CAMERA_NUM
    iw, ih = cfg.DATASET.IMAGE_SIZE
    model = seeded(build_model, cfg, 0, device)
    backbone = seeded(build_backbone, cfg, 0, device)
    cams = torch.as_tensor(bench_rig(cfg)).to(device)
    rng = np.random.RandomState(0)

    def frames(shape):  # bench.py's make_runner draws each length's frames in turn
        return lambda F: (torch.as_tensor(rng.randn(F, *shape).astype(np.float32)).to(device),)

    lat = scan_slope(frame_step(model, backbone, cams), *lengths["latency"], device,
                     frames((V, ih, iw, 3)))
    tput = scan_slope(batched_frame_step(model, backbone, cams), *lengths["throughput"], device,
                      frames((batch, V, ih, iw, 3)))
    fps, tput_fps = 1e3 / lat.host_ms, batch * 1e3 / tput.host_ms
    slots = torch.cat([valid_slots(r.outputs).flatten() for r in
                       (lat.short, lat.long, tput.short, tput.long)])
    return {
        "metric": METRIC,
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
        "throughput_fps": round(tput_fps, 2),
        "throughput_batch": batch,
        "latency_device_ms": lat.device_ms,
        "throughput_device_ms": tput.device_ms,
        "worst_case_valid_slots": [int(slots.min()), int(slots.max())],
        "graph_launches": {"latency": launches_of(lat), "throughput": launches_of(tput)},
    }


def launches_of(s: Slope) -> Dict[int, Dict[str, int]]:
    """The kernel launches of one replay of each length's graph."""
    return {len(s.short.outputs): s.short.launches, len(s.long.outputs): s.long.launches}


def realistic_scenes(cfg: Config, frames: int = REALISTIC_FRAMES, dataset=None) -> dict:
    """The first `frames` held-out scenes of the 64 that bench.py builds
    (SYNTHETIC.NUM_DATA 64, heatmaps rendered on the host), or of
    `dataset(cfg)`, a maker of the test set, where given: heatmaps
    (F, V, H, W, J), cameras (F, V, 21) and the people in each."""
    from .validate import held_out_dataset

    cfg.DATASET.DEVICE_RENDER = False
    ds = held_out_dataset(cfg, 64) if dataset is None else dataset(cfg)
    samples = [ds[i] for i in range(frames)]
    return {"heatmaps": np.stack([s["input_heatmaps"] for s in samples]),
            "cameras": np.stack([s["cameras"] for s in samples]),
            "num_person": np.array([int(s["num_person"]) for s in samples])}


def detected_people(model, heatmaps: torch.Tensor, cams: torch.Tensor) -> np.ndarray:
    """The valid proposals of each frame, the frames in one batch."""
    with torch.inference_mode():
        centers = model(heatmaps, cams).proposal_centers
    return (centers[:, :, 3] >= 0).sum(1).cpu().numpy()


def realistic_bench(cfg: Config, device: torch.device, snapshot=SNAPSHOT, lengths=LENGTHS,
                    batch: int = 8) -> dict:
    """bench.py's realistic_bench: the trained detector on held-out scenes,
    fusion alone and the whole pipeline, per frame and per batch."""
    from ..engine.checkpoint import load_best_npz

    if not pathlib.Path(snapshot).exists():
        raise FileNotFoundError(f"no committed checkpoint at {snapshot}")
    scenes = realistic_scenes(cfg)
    heatmaps, cams_r = scenes["heatmaps"], scenes["cameras"]
    V = cfg.DATASET.CAMERA_NUM
    iw, ih = cfg.DATASET.IMAGE_SIZE
    model = load_best_npz(str(snapshot), build_model(cfg)).to(device)
    backbone = seeded(build_backbone, cfg, 1, device)
    detected = detected_people(model, torch.as_tensor(heatmaps).to(device),
                               torch.as_tensor(cams_r).to(device))
    images = np.random.RandomState(1).randn(4, V, ih, iw, 3).astype(np.float32)
    hm_b = np.resize(heatmaps, (batch,) + heatmaps.shape[1:])[None]
    cam_b = np.resize(cams_r, (batch,) + cams_r.shape[1:])[None]
    img_b = np.resize(images, (batch,) + images.shape[1:])[None]
    runs = {
        "fusion": (fusion_step(model), (heatmaps, cams_r), 1),
        "fusion_batched": (fusion_step_batched(model), (hm_b, cam_b), batch),
        "e2e": (e2e_step(model, backbone), (heatmaps, cams_r, images), 1),
        "e2e_batched": (e2e_step_batched(model, backbone), (hm_b, cam_b, img_b), batch),
    }
    out, launches = {}, {}
    for mode, (step, arrays, per) in runs.items():
        s = scan_slope(summed(step), *lengths[mode], device, staged(arrays, device))
        out[mode] = (per * 1e3 / s.host_ms, s.device_ms)
        launches[mode] = launches_of(s)
    return {
        "realistic_e2e_fps": round(out["e2e"][0], 2),
        "realistic_e2e_fps_batched": round(out["e2e_batched"][0], 2),
        "realistic_fusion_fps": round(out["fusion"][0], 2),
        "realistic_fusion_fps_batched": round(out["fusion_batched"][0], 2),
        "realistic_batch": batch,
        "realistic_true_people": round(float(scenes["num_person"].mean()), 2),
        "realistic_detected_people": round(float(detected.mean()), 2),
        "realistic_min_score": cfg.CAPTURE_SPEC.MIN_SCORE,
        "realistic_note": REALISTIC_NOTE,
        **{f"realistic_{m}_device_ms": out[m][1] for m in runs},
        "realistic_graph_launches": launches,
    }


def check_line(line: dict) -> None:
    """Raise unless the line holds every key of bench.py's line and a
    device time per mode, and every rate is finite and positive."""
    missing = [k for k in HEADLINE_KEYS + REALISTIC_KEYS + DEVICE_KEYS if k not in line]
    if missing:
        raise AssertionError(f"bench line lacks {missing}")
    bad = [k for k in RATE_KEYS if not (math.isfinite(line[k]) and line[k] > 0)]
    if bad:
        raise AssertionError(f"bench rates not finite and positive: {[(k, line[k]) for k in bad]}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description="End-to-end benchmark: worst case and realistic load")
    p.add_argument("--device", default=None, help="default: the CUDA device (cpu: tests only)")
    p.add_argument("--cfg", default=str(WORST_CASE_CFG), help="the worst case's config")
    p.add_argument("--realistic-cfg", default=str(REALISTIC_CFG))
    p.add_argument("--checkpoint", default=str(SNAPSHOT), help="the realistic load's weights")
    p.add_argument("--lengths", default=None,
                   help="F1,F2 for every mode in place of bench.py's (tests)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    pin_float32()
    lengths = LENGTHS
    if args.lengths:
        pair = tuple(int(n) for n in args.lengths.split(","))
        lengths = {mode: pair for mode in LENGTHS}
    batch = int(os.environ.get("BENCH_THROUGHPUT_BATCH", "8"))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    sk.reset_launch_counts()
    line = worst_case(worst_case_config(args.cfg), device, lengths, batch)
    line.update(realistic_bench(load_config(args.realistic_cfg), device, args.checkpoint,
                                lengths, batch))
    check_line(line)
    print(device_line(device))
    if device.type == "cuda":
        print(f"peak memory allocated {torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB")
    print(f"kernel launches: {json.dumps(sk.launch_counts())}")
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    from ..utils.bench_lock import hold_bench_lock

    with hold_bench_lock():
        sys.exit(main(sys.argv[1:]))
