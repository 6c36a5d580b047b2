"""Block-shape sweep of the JLN's plane-projection kernel on the card
(counterpart of scripts/sweep_planes.py):

    python3 -m faster_voxelpose_tpu_torch.tools.sweep_planes [--variants a,b] [--device cpu]

The script varies the Pallas kernel's tile and VMEM window.  Their
counterparts here are the crop kernel's block shape in
`csrc/sampling.cu`: its tile of kTX x kTY columns of kTZ voxels and its
kThreads threads a block, set by `-DFVP_CROP_TX/TY/TZ` and
`-DFVP_THREADS` (the production build passes no define).  Each variant is
built into a library of its own under build/kernels/ (all in parallel)
and launched through `sampling_kernels.kernel_variant`.  The window sizes
have no counterpart: the CUDA kernel gathers from L2 and stages no
window.

The path is the production one at configs/panoptic/jln64.yaml:
`sample_crop_planes` on 5 views of 240 x 128 x 15 heatmaps (RandomState(0)
draws x 0.5), the script's dome rig, K = 10 crop centres and bbox sizes
drawn as the script draws them, and the masks of `crop_axis_masks`.  The
script's validity-mode axis is kept: every one of the K slots valid, and
the served validity, the first SERVED_PEOPLE = 4 slots valid (about the
people per frame that the realistic load detects).  Per variant
and mode: ms (the slope between scans of 2 and 10 steps, device clock),
the max error of the planes against the plain version, and the launch
geometry (`crop_launch_geometry`: grid, threads, shared memory, tile).  A
variant that fails to build or launch prints FAILED with the reason, and
the tool then exits non-zero.  The last line is one JSON object.
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
from ..models.projection import (compute_crop_origin, crop_axis_masks, crop_projection,
                                 make_projection_geometry)
from ..ops import cuda_build
from ..ops import sampling_kernels as sk
from .profile_stages import stage_step
from .timing import device_line, scan_slope

REPO = pathlib.Path(__file__).resolve().parents[2]
CFG = REPO / "configs" / "panoptic" / "jln64.yaml"
LENGTHS = (2, 10)
PRODUCTION = "t4432_n256 (production)"
SERVED_PEOPLE = 4


def _defines(tx, ty, tz, threads):
    return (f"FVP_CROP_TX={tx}", f"FVP_CROP_TY={ty}", f"FVP_CROP_TZ={tz}", f"FVP_THREADS={threads}")


# (name, -D defines); the production row is the production build
VARIANTS = [
    (PRODUCTION, ()),
    ("t8832_n256", _defines(8, 8, 32, 256)),
    ("t4416_n256", _defines(4, 4, 16, 256)),
    ("t8432_n256", _defines(8, 4, 32, 256)),
    ("t4832_n256", _defines(4, 8, 32, 256)),
    ("t2232_n256", _defines(2, 2, 32, 256)),
    ("t4432_n128", _defines(4, 4, 32, 128)),
    ("t4432_n512", _defines(4, 4, 32, 512)),
    ("t8816_n512", _defines(8, 8, 16, 512)),
]


def planes_case(device: torch.device, cfg_path=CFG, served_people: int = SERVED_PEOPLE):
    """The script's inputs on `device`: heatmaps (1, V, H, W, J), rig,
    crop origins, masks, and the two validity modes."""
    cfg = load_config(str(cfg_path))
    geom = make_projection_geometry(cfg)
    V, K = cfg.DATASET.CAMERA_NUM, cfg.CAPTURE_SPEC.MAX_PEOPLE
    W, H = cfg.DATASET.HEATMAP_SIZE
    rng = np.random.RandomState(0)
    hm = torch.as_tensor((rng.rand(1, V, H, W, cfg.DATASET.NUM_JOINTS) * 0.5).astype(np.float32)).to(device)
    cams = torch.as_tensor(dome_rig(1, V))[0].to(device)
    centers = rng.uniform(-1200, 1200, (K, 3)).astype(np.float32)
    centers[:, 2] = rng.uniform(600, 1100, K)
    tl, _ = compute_crop_origin(geom, torch.as_tensor(centers).to(device))
    bbox = torch.as_tensor(rng.uniform(0.4, 0.9, (K, 2)).astype(np.float32)).to(device)
    masks = tuple(m.to(torch.uint8).contiguous() for m in crop_axis_masks(geom, tl, bbox))
    modes = {"all K valid": torch.ones((K,), dtype=torch.uint8, device=device),
             f"served ({served_people} of {K} valid)":
                 (torch.arange(K, device=device) < served_people).to(torch.uint8)}
    return dict(hm=hm, cams=cams.contiguous(), tl=tl.to(torch.int32).contiguous(), masks=masks,
                modes=modes, crop=crop_projection(geom), V=V, J=hm.shape[-1], K=K,
                voxels=tuple(geom.ind_voxels_per_axis))


def run_variant(case, device, lengths) -> dict:
    """One variant's readings in both validity modes (inside its
    kernel_variant)."""
    hm, cams, tl, crop = case["hm"], case["cams"], case["tl"], case["crop"]
    out = {}
    for mode, valid in case["modes"].items():
        def planes(a, valid=valid):
            return sk.sample_crop_planes(a[0], cams, tl, *case["masks"], valid, crop)[0][..., 0]

        with torch.no_grad():
            got = sk.sample_crop_planes(hm[0], cams, tl, *case["masks"], valid, crop)
            ref = sk.sample_crop_planes_plain(hm[0], cams, tl, *case["masks"], valid, crop)
            err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
            s = scan_slope(stage_step(planes, hm), *lengths, device)
        out[mode] = {"ms": s.device_ms if s.device_ms is not None else s.host_ms,
                     "host_ms": s.host_ms, "err": err}
    if device.type == "cuda":
        out["launch"] = sk.crop_launch_geometry(case["V"], case["J"], case["K"], case["voxels"],
                                                project=True, cube=False)
    return out


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
    case = planes_case(device, args.cfg)
    rows, failed = [], []
    for name, defines in variants:
        try:
            if built[defines]:
                raise RuntimeError(built[defines])
            with sk.kernel_variant(defines):
                r = run_variant(case, device, lengths)
        except Exception as e:  # reported here, and the tool fails at the end
            failed.append(name)
            print(f"{name:26s}: FAILED {str(e)[:300]}", flush=True)
            continue
        modes = "  ".join(f"{m}: {v['ms']:8.4f} ms err {v['err']:.1e}"
                          for m, v in r.items() if m != "launch")
        print(f"{name:26s}: {modes}  launch {r.get('launch')} | {where}", flush=True)
        rows.append(dict(name=name, defines=list(defines), **r))
    print(json.dumps({"variants": rows, "failed": failed}))
    if failed:
        raise SystemExit(f"{len(failed)} of {len(variants)} variants failed: {failed}")
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
