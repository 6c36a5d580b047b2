"""Block-shape sweep of the whole-space (HDN) sampling kernel on the card
(counterpart of scripts/sweep_whole.py):

    python3 -m faster_voxelpose_tpu_torch.tools.sweep_whole [--variants a,b] [--device cpu]

The script varies the Pallas kernel's tile and VMEM window.  The
counterpart here is the block of `sample_whole_projected` in
`csrc/sampling.cu`: kWholeVoxels, the voxels and threads of a block, set
by `-DFVP_WHOLE_VOXELS` (the production build passes no define and takes
256).  Each variant is built into a library of its own under
build/kernels/ (all in parallel) and launched through
`sampling_kernels.kernel_variant`.

The path is the HDN's at configs/panoptic/jln64.yaml: 5 views of 240 x
128 x 15 heatmaps (RandomState(0) draws x 0.8), the script's dome rig,
the 80 x 80 x 20 grid, batch 1.  Per variant: ms (the slope between scans
of 2 and 10 steps, device clock), the max error against the plain version
(the script compares with its quad path) and the launch geometry
(`whole_launch_geometry`: grid, threads, shared memory, voxels a block);
then the plain version's time (the script's "quad+table" line).  The
script's `fast_rate` (:50-90), the share of (tile, view) blocks whose
anchored VMEM window covers their footprint, is a property of the TPU
kernel's window alone: the CUDA kernel gathers every corner from L2 and
has no slow path, so it has no counterpart and is not printed.  A variant
that fails to build or launch prints FAILED with the reason, and the tool
then exits non-zero.  The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import load_config
from ..device import pin_float32, resolve_device
from ..geometry import dome_rig
from ..models.projection import make_projection_geometry, whole_axes, whole_projection
from ..ops import cuda_build
from ..ops import sampling_kernels as sk
from .profile_stages import stage_step
from .timing import device_line, scan_slope

REPO = pathlib.Path(__file__).resolve().parents[2]
CFG = REPO / "configs" / "panoptic" / "jln64.yaml"
LENGTHS = (2, 10)
PRODUCTION = "v256 (production)"

# (name, -D defines); the production row is the production build
VARIANTS = [
    ("v64", ("FVP_WHOLE_VOXELS=64",)),
    ("v128", ("FVP_WHOLE_VOXELS=128",)),
    (PRODUCTION, ()),
    ("v512", ("FVP_WHOLE_VOXELS=512",)),
    ("v1024", ("FVP_WHOLE_VOXELS=1024",)),
]


def whole_case(device: torch.device, cfg_path=CFG) -> dict:
    """The script's inputs on `device`: heatmaps (1, V, H, W, J), the rig
    (1, V, 21), the grid's axes and the projection constants."""
    cfg = load_config(str(cfg_path))
    geom = make_projection_geometry(cfg)
    V = cfg.DATASET.CAMERA_NUM
    W, H = cfg.DATASET.HEATMAP_SIZE
    rng = np.random.RandomState(0)
    hm = torch.as_tensor((rng.rand(1, V, H, W, cfg.DATASET.NUM_JOINTS) * 0.8).astype(np.float32)).to(device)
    cams = torch.as_tensor(dome_rig(1, V)).to(device)
    axes = tuple(torch.as_tensor(a).to(device) for a in whole_axes(geom))
    return dict(hm=hm, cams=cams, axes=axes, proj=whole_projection(geom), V=V,
                grid=tuple(geom.voxels_per_axis))


def timed(fn, case, device, lengths):
    with torch.no_grad():
        s = scan_slope(stage_step(lambda a: fn(a, case["cams"], case["axes"], case["proj"])
                                  [..., 0], case["hm"]), *lengths, device)
    return s.device_ms if s.device_ms is not None else s.host_ms


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variants", default=None, help="comma-separated variant names")
    p.add_argument("--cfg", default=str(CFG), help="the profile (default configs/panoptic/jln64.yaml)")
    p.add_argument("--device", default=None, help="default: the CUDA device (cpu: tests only)")
    p.add_argument("--lengths", default=None, help="F1,F2 in place of 2,10 (tests)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    pin_float32()
    lengths = tuple(int(n) for n in args.lengths.split(",")) if args.lengths else LENGTHS
    wanted = args.variants.split(",") if args.variants else None
    variants = [v for v in VARIANTS if wanted is None or v[0].split()[0] in wanted]
    where = device_line(device)
    built = (cuda_build.build_variants("sampling", [d for _, d in variants])
             if device.type == "cuda" else {d: None for _, d in variants})
    case = whole_case(device, args.cfg)
    with torch.no_grad():
        ref = sk.sample_whole_projected_plain(case["hm"], case["cams"], case["axes"], case["proj"])
    rows, failed = [], []
    for name, defines in variants:
        try:
            if built[defines]:
                raise RuntimeError(built[defines])
            with sk.kernel_variant(defines):
                with torch.no_grad():
                    out = sk.sample_whole_projected(case["hm"], case["cams"], case["axes"],
                                                    case["proj"])
                err = float((out - ref).abs().max())
                ms = timed(sk.sample_whole_projected, case, device, lengths)
                launch = (sk.whole_launch_geometry(case["V"], case["grid"], 1)
                          if device.type == "cuda" else None)
        except Exception as e:  # reported here, and the tool fails at the end
            failed.append(name)
            print(f"{name:20s}: FAILED {str(e)[:300]}", flush=True)
            continue
        print(f"{name:20s}: {ms:8.4f} ms  err {err:.1e}  launch {launch} | {where}", flush=True)
        rows.append(dict(name=name, defines=list(defines), ms=ms, err=err, launch=launch))
    plain = timed(sk.sample_whole_projected_plain, case, device, lengths)
    print(f"{'plain version':20s}: {plain:8.4f} ms | {where}")
    print(json.dumps({"variants": rows, "plain_ms": plain, "failed": failed}))
    if failed:
        raise SystemExit(f"{len(failed)} of {len(variants)} variants failed: {failed}")
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
