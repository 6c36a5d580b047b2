"""Smoke and parity of the sampling kernels on the card (counterpart of
scripts/smoke_kernel_tpu.py):

    python3 -m faster_voxelpose_tpu_torch.tools.smoke_kernels [--quick] [--device cpu]

The script's five checks, each on the CUDA kernels against their plain
PyTorch versions on the same tensors (max abs error <= 1e-5 on values in
[0, 1]; the CUDA kernels are exact float32, so the script's looser bf16
bound has no counterpart):

1. compact-tile crop sampling: 64 blocks of 512 samples per view, each
   block's coords within 8 px of a centre drawn over the heatmap and 6 px
   past its edges, at the Panoptic JLN's heatmaps (5 views of 240 x 128 x
   15).  A block is one slot of a 4 x 4 x 32 crop, one block of the crop
   kernel's production tile, so the compact coords are compact in the
   kernel's own block;
2. the same with "wild" coords, every 4th block's samples uniform over the
   image and 8 px past it (:83-90), where a TPU window would have needed
   its full-cover loop;
3. joint groups at the COCO-17 Shelf profile (5 views of 200 x 152 x 17,
   every 8th block wild), then the script's whole-space block shape (4 x 4
   x 20 tiles, 40 blocks, 20 px jitter, every 3rd wild);
4. whole-space projection at configs/panoptic/jln64.yaml with camera 0
   replaced by one 0.8 m in front of the space centre and 0.6 m above it
   (:139-170): `sample_whole_projected` against its plain version;
5. slope timings (`tools.timing.scan_slope`, 2 and 10 steps) of the crop
   pass (`sample_crop_planes`, K = 10 slots, profile_stages' stage 4), the
   whole-space pass (`sample_whole_projected`) and its plain version (the
   counterpart of the script's quad path with its table build).

Checks 1-3 run each coords case through `sample_crop_cube` and
`sample_crop_planes_coords` (pixels from the coords) and `sample_whole`
(the same coords flat).  The script runs each of them twice, in the TPU
kernel's exact and bf16 product modes; the CUDA kernels have one mode,
so each runs once.  --quick stops after check 3.  Exits non-zero when
any check misses; the last line is one JSON object of the errors and
times.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..device import pin_float32, resolve_device
from ..geometry import dome_rig, pack_rig
from ..ops import sampling_kernels as sk
from .profile_stages import stage_step, stages
from .timing import device_line, scan_slope

REPO = pathlib.Path(__file__).resolve().parents[2]
CFG = REPO / "configs" / "panoptic" / "jln64.yaml"
TOL = 1e-5
LENGTHS = (2, 10)


def block_coords(rng, V, H, W, s, nb, jitter, wild_every=None) -> np.ndarray:
    """The script's coords (nb, V, 2, s) float32 (smoke_kernel_tpu.py:73-91):
    per block and view a centre within 6 px of the heatmap, samples within
    `jitter` of it; every `wild_every`-th block uniform over the image and
    8 px past it."""
    centers = np.stack([rng.uniform(-6, W + 6, (nb, V, 1)),
                        rng.uniform(-6, H + 6, (nb, V, 1))], axis=2)
    coords = centers + rng.uniform(-jitter, jitter, (nb, V, 2, s))
    if wild_every:
        for b in range(0, nb, wild_every):
            coords[b, :, 0, :] = rng.uniform(-8, W + 8, (V, s))
            coords[b, :, 1, :] = rng.uniform(-8, H + 8, (V, s))
    return coords.astype(np.float32)


def check_coords(name, device, V, H, W, J, tile, nb, jitter, wild_every=None,
                 seed=0) -> Dict[str, float]:
    """One coords case through the three coords kernels against their
    plain versions: {kernel: max abs error}."""
    rng = np.random.RandomState(seed)
    hm = rng.rand(V, H, W, J).astype(np.float32)
    s = int(np.prod(tile))
    coords = block_coords(rng, V, H, W, s, nb, jitter, wild_every)
    hm_d = torch.as_tensor(hm).to(device)
    pix = torch.as_tensor(coords.transpose(0, 1, 3, 2).copy()).to(device)  # (K, V, s, 2)
    ones = [torch.ones((nb, t), dtype=torch.uint8, device=device) for t in tile]
    valid = torch.ones((nb,), dtype=torch.uint8, device=device)
    errs = {}
    with torch.no_grad():
        cube = sk.sample_crop_cube(hm_d, *ones, valid, pix=pix)
        errs["sample_crop_cube"] = float(
            (cube - sk.sample_crop_coords_plain(hm_d, pix, *ones, valid, cube=True)).abs().max())
        planes = sk.sample_crop_planes_coords(hm_d, pix, *ones, valid)
        ref = sk.sample_crop_coords_plain(hm_d, pix, *ones, valid)
        errs["sample_crop_planes_coords"] = max(float((a - b).abs().max())
                                                for a, b in zip(planes, ref))
        flat = pix.permute(1, 0, 2, 3).reshape(V, nb * s, 2).contiguous()
        errs["sample_whole"] = float(
            (sk.sample_whole(hm_d, flat) - sk.sample_whole_plain(hm_d, flat)).abs().max())
    for kernel, err in errs.items():
        print(f"{name} [{kernel}]: max err {err:.2e} ({'OK' if err <= TOL else 'FAIL'})",
              flush=True)
    return errs


def near_camera_rig(cfg) -> np.ndarray:
    """The (V, 21) dome rig of the profile with camera 0 replaced by one
    0.8 m in front of the space centre, 0.6 m above it (the script's)."""
    V = cfg.DATASET.CAMERA_NUM
    cams = np.asarray(dome_rig(1, V))[0].copy()
    center = np.asarray(cfg.CAPTURE_SPEC.SPACE_CENTER)
    cams[0] = pack_rig([{
        "R": np.eye(3),
        "T": (center + np.array([0.0, -800.0, 600.0]))[:, None],
        "fx": 1500.0, "fy": 1500.0, "cx": 960.0, "cy": 540.0,
        "k": np.zeros((3, 1)), "p": np.zeros((2, 1)),
    }])[0]
    return cams.astype(np.float32)


def check_near_camera(device, cfg_path=CFG) -> tuple:
    """Check 4: the whole-space sampler with a 0.8 m camera against its
    plain version; returns (max error, the model's geometry pieces)."""
    from ..config import load_config
    from ..models import build_model
    from ..models.projection import whole_projection

    cfg = load_config(str(cfg_path))
    model = build_model(cfg).to(device)
    hdn = model.hdn
    axes = (hdn.whole_gx, hdn.whole_gy, hdn.whole_gz)
    V = cfg.DATASET.CAMERA_NUM
    W, H = cfg.DATASET.HEATMAP_SIZE
    J = cfg.DATASET.NUM_JOINTS
    rng = np.random.RandomState(1)
    hm = torch.as_tensor((rng.rand(1, V, H, W, J) * 0.8).astype(np.float32)).to(device)
    cams = torch.as_tensor(near_camera_rig(cfg))[None].to(device)
    proj = whole_projection(model.geom)
    with torch.no_grad():
        ours = sk.sample_whole_projected(hm, cams, axes, proj)
        ref = sk.sample_whole_projected_plain(hm, cams, axes, proj)
    err = float((ours - ref).abs().max())
    print(f"whole-space vs plain (0.8m cam): max err {err:.2e} "
          f"({'OK' if err <= TOL else 'FAIL'})", flush=True)
    return err, (hm, cams, axes, proj)


def slope_timings(device, pieces, lengths=LENGTHS, cfg_path=CFG) -> Dict[str, float]:
    """Check 5: the crop pass, the whole-space pass and its plain version,
    ms a step (the device's clock on the card)."""
    hm, cams, axes, proj = pieces
    st = stages(cfg_path, device, ["4"])
    fns = {
        "crop pass (sample_crop_planes, all K slots)": st["jln_planes"],
        "whole-space pass (sample_whole_projected)":
            (lambda a: sk.sample_whole_projected(a, cams, axes, proj)[..., 0], hm),
        "whole-space plain version":
            (lambda a: sk.sample_whole_projected_plain(a, cams, axes, proj)[..., 0], hm),
    }
    out = {}
    for label, (fn, x) in fns.items():
        with torch.no_grad():
            s = scan_slope(stage_step(fn, x), *lengths, device)
        out[label] = s.device_ms if s.device_ms is not None else s.host_ms
        print(f"{label}: {out[label]:.4f} ms", flush=True)
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--quick", action="store_true", help="checks 1-3 only")
    p.add_argument("--cfg", default=str(CFG), help="the profile of checks 4-5 (default "
                   "configs/panoptic/jln64.yaml)")
    p.add_argument("--device", default=None, help="default: the CUDA device (cpu: tests only)")
    p.add_argument("--lengths", default=None, help="F1,F2 in place of 2,10 (tests)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    pin_float32()
    lengths = tuple(int(n) for n in args.lengths.split(",")) if args.lengths else LENGTHS
    print(f"device: {device_line(device)}")
    before = sk.launch_counts()
    errs = {
        "jln compact": check_coords("jln compact", device, 5, 128, 240, 15, (4, 4, 32), 64, 8),
        "jln wild": check_coords("jln wild", device, 5, 128, 240, 15, (4, 4, 32), 64, 8, 4),
        "shelf17 wild": check_coords("shelf17 wild", device, 5, 152, 200, 17, (4, 4, 32),
                                     64, 8, 8),
        "whole wild": check_coords("whole wild", device, 5, 128, 240, 15, (4, 4, 20), 40, 20, 3),
    }
    times = {}
    if not args.quick:
        err, pieces = check_near_camera(device, args.cfg)
        errs["whole near camera"] = {"sample_whole_projected": err}
        times = slope_timings(device, pieces, lengths, args.cfg)
    misses = [f"{case} [{k}]" for case, e in errs.items() for k, v in e.items()
              if not v <= TOL]
    line = {"errors": errs, "ms": times, "tolerance": TOL, "misses": misses,
            "launches": {k: n - before[k] for k, n in sk.launch_counts().items()
                         if n != before[k]}}
    print(json.dumps(line))
    if misses:
        raise SystemExit(f"smoke_kernels: {len(misses)} checks missed: {misses}")
    return line


if __name__ == "__main__":
    main(sys.argv[1:])
