"""Realistic-load throughput of any config's trained detector at its own
MIN_SCORE (counterpart of scripts/bench_realistic.py):

    python3 -m faster_voxelpose_tpu_torch.tools.bench_realistic [CONFIG.yaml] [--device cpu]
    BENCH_THROUGHPUT_BATCH=4 python3 -m faster_voxelpose_tpu_torch.tools.bench_realistic configs/demo/panoptic_synthetic.yaml

The config (default configs/demo/synthetic.yaml) names the test set and
the best model: `<OUTPUT_DIR>/<TEST_DATASET>/<cfg stem>/model_best.npz`,
else the committed snapshot `checkpoints/<cfg stem>`, as the JAX
package's `load_best_model` falls back to it.  The first 24 scenes of the config's test set, heatmaps
rendered on the host (DEVICE_RENDER off), go through heatmaps -> poses:

- detected against true people per frame at the config's MIN_SCORE;
- ms per frame by the slope between scans of 3 and 18 frames;
- batched throughput at BENCH_THROUGHPUT_BATCH frames a step (default 8),
  the slope between 1 and 4 steps, each step a batch of the next frames.

A thin command line over `tools/bench.py`'s realistic functions
(`realistic_scenes`, `detected_people`, `fusion_step`,
`fusion_step_batched`, `summed`, `staged`); each measurement is one CUDA
graph of F steps (`tools.timing.scan_slope`), read on the host's clock
(the script's number) and the device's.  As in tools/bench.py, detected
people are averaged over the same 24 frames as true people (the script
takes the first 8).  The last line is one JSON object of the readings.
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

from ..config import load_config
from ..datasets import get_dataset
from ..device import pin_float32, resolve_device
from ..engine.checkpoint import load_best_model
from ..models import build_model
from . import bench
from .timing import device_line, scan_slope

REPO = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_CFG = REPO / "configs" / "demo" / "synthetic.yaml"
LENGTHS = {"fusion": (3, 18), "fusion_batched": (1, 4)}  # the script's scan lengths


def config_test_set(cfg):
    """The config's test set, as the script builds it."""
    return get_dataset(cfg.DATASET.TEST_DATASET)(cfg, is_train=False)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("cfg", nargs="?", default=str(DEFAULT_CFG))
    p.add_argument("--device", default=None, help="default: the CUDA device (cpu: tests only)")
    p.add_argument("--lengths", default=None, help="F1,F2 for both modes (tests)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    pin_float32()
    lengths = LENGTHS
    if args.lengths:
        pair = tuple(int(n) for n in args.lengths.split(","))
        lengths = {mode: pair for mode in LENGTHS}

    cfg = load_config(args.cfg)
    scenes = bench.realistic_scenes(cfg, bench.REALISTIC_FRAMES, config_test_set)
    heatmaps, cams = scenes["heatmaps"], scenes["cameras"]
    stem = os.path.splitext(os.path.basename(args.cfg))[0]
    output_dir = os.path.join(cfg.OUTPUT_DIR, cfg.DATASET.TEST_DATASET, stem)
    model = load_best_model(output_dir, build_model(cfg), repo_snapshot_fallback=True).to(device)
    print(f"=> loaded {output_dir}", file=sys.stderr)

    detected = bench.detected_people(model, torch.as_tensor(heatmaps).to(device),
                                     torch.as_tensor(cams).to(device))
    true_people = float(scenes["num_person"].mean())
    det = float(detected.mean())
    min_score = cfg.CAPTURE_SPEC.MIN_SCORE
    print(f"scenes: true people/frame {true_people:.2f}, detected/frame {det:.2f} "
          f"(MIN_SCORE={min_score})")

    s = scan_slope(bench.summed(bench.fusion_step(model)), *lengths["fusion"], device,
                   bench.staged((heatmaps, cams), device))
    print(f"realistic-load heatmaps->poses: {s.host_ms:.1f} ms/frame "
          f"({1e3 / s.host_ms:.1f} fps) at {det:.1f} detected people; device "
          f"{s.device_ms if s.device_ms is None else round(s.device_ms, 4)} ms/frame")

    tb = int(os.environ.get("BENCH_THROUGHPUT_BATCH", "8"))
    steps = lengths["fusion_batched"][1]
    hm_b = np.resize(heatmaps, (steps, tb) + heatmaps.shape[1:])
    cam_b = np.resize(cams, (steps, tb) + cams.shape[1:])
    b = scan_slope(bench.summed(bench.fusion_step_batched(model)), *lengths["fusion_batched"],
                   device, bench.staged((hm_b, cam_b), device))
    print(f"realistic-load throughput (B={tb}): {b.host_ms / tb:.1f} ms/frame "
          f"({tb * 1e3 / b.host_ms:.1f} fps) at {det:.1f} detected people; device "
          f"{b.device_ms if b.device_ms is None else round(b.device_ms / tb, 4)} ms/frame")
    print(device_line(device))
    line = {"true_people": true_people, "detected_people": det, "min_score": min_score,
            "ms_per_frame": s.host_ms, "device_ms_per_frame": s.device_ms,
            "batch": tb, "batched_ms_per_frame": b.host_ms / tb,
            "batched_device_ms_per_frame": None if b.device_ms is None else b.device_ms / tb,
            "launches": {"fusion": bench.launches_of(s), "fusion_batched": bench.launches_of(b)}}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main(sys.argv[1:])
