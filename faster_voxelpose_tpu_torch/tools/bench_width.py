"""Fusion-stage speed of a WIDTH_MULT variant against the full-width trunk
on the card (counterpart of the JAX package's scripts/bench_width.py):

    python3 -m faster_voxelpose_tpu_torch.tools.bench_width \
        [--cfg configs/demo/panoptic_synthetic.yaml] \
        [--cfg-narrow configs/demo/panoptic_synthetic_w05.yaml]

Times the heatmaps -> poses forward (the part WIDTH_MULT changes; the
backbone does not depend on it) of both configs by the scan slope of
`tools.timing.scan_slope` between 3 and 18 frames, one frame per step,
on the first 8 held-out synthetic scenes of each profile (heatmaps
rendered on the host) cycled, with the repository's snapshot
checkpoints/<cfg stem> where it exists and seeded random weights
otherwise (timing depends on the shapes only; the line says which).
Prints one JSON line {"base", "narrow", "narrow_speedup"} with the
script's keys, each side's device ms per frame beside its host ms, and
the speed-up on the device's clock.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import load_config
from ..device import pin_float32, resolve_device
from ..engine.checkpoint import load_best_npz, repo_snapshot_dir
from ..models import build_model
from ..ops import sampling_kernels as sk
from .bench import REPO, seeded, staged
from .timing import device_line, scan_slope

LENGTHS = (3, 18)  # the script's run_for(18) - run_for(3)
BASE_CFG = REPO / "configs" / "demo" / "panoptic_synthetic.yaml"
NARROW_CFG = REPO / "configs" / "demo" / "panoptic_synthetic_w05.yaml"


def fusion_step(model):
    """The script's scan body: one frame's heatmaps (1, V, H, W, J) and rig
    (1, V, 21) plus 1e-30 of the carry -> 1e-30 of the fused poses' sum."""

    def step(carry, x):
        h, c = x
        s = model(h + carry * 1e-30, c).fused_poses.sum() * 1e-30
        return s, s

    return step


def time_fusion(cfg_path, device: torch.device, lengths=LENGTHS) -> dict:
    """One config's fusion forward, ms and frames/s per frame."""
    from .validate import held_out_dataset

    cfg = load_config(cfg_path)
    cfg.DATASET.DEVICE_RENDER = False
    ds = held_out_dataset(cfg, 8)
    samples = [ds[i] for i in range(len(ds))]
    hm = np.stack([s["input_heatmaps"] for s in samples])[:, None]
    cams = np.stack([s["cameras"] for s in samples])[:, None]
    snap = repo_snapshot_dir(pathlib.PurePath(cfg_path).stem) / "model_best.npz"
    trained = snap.exists()
    model = seeded(build_model, cfg, 0, device)
    if trained:
        load_best_npz(str(snap), model)
    s = scan_slope(fusion_step(model), *lengths, device, staged((hm, cams), device))
    return {
        "cfg": str(cfg_path),
        "width_mult": cfg.NETWORK.WIDTH_MULT,
        "fusion_ms_per_frame": round(s.host_ms, 2),
        "fusion_fps": round(1e3 / s.host_ms, 2),
        "params": sum(v.numel() for v in model.state_dict().values()),
        "weights": "trained snapshot" if trained else "random init (timing only)",
        "fusion_device_ms_per_frame": s.device_ms,
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Fusion speed of a WIDTH_MULT variant")
    p.add_argument("--cfg", default=str(BASE_CFG))
    p.add_argument("--cfg-narrow", default=str(NARROW_CFG))
    p.add_argument("--device", default=None, help="default: the CUDA device (cpu: tests only)")
    p.add_argument("--lengths", default=None, help="F1,F2 in place of 3,18 (tests)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    pin_float32()
    lengths = tuple(int(n) for n in args.lengths.split(",")) if args.lengths else LENGTHS
    sk.reset_launch_counts()
    base = time_fusion(args.cfg, device, lengths)
    narrow = time_fusion(args.cfg_narrow, device, lengths)
    line = {"base": base, "narrow": narrow,
            "narrow_speedup": round(base["fusion_ms_per_frame"] / narrow["fusion_ms_per_frame"], 3)}
    if device.type == "cuda":
        line["narrow_device_speedup"] = (base["fusion_device_ms_per_frame"]
                                         / narrow["fusion_device_ms_per_frame"])
    print(device_line(device))
    print(f"kernel launches: {json.dumps(sk.launch_counts())}")
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
