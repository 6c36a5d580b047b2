"""Every sampling route of the full model at a real profile, against the
default route, with per-variant frame times (counterpart of
scripts/check_pallas_parity.py):

    python3 -m faster_voxelpose_tpu_torch.tools.check_sampling_parity [--cfg CONFIG.yaml] \
        [--only=name1,name2] [--no-timing] [--device cpu]

The default profile is Panoptic (configs/panoptic/jln64.yaml, a dome rig:
`dome_cameras` with the profile's centre and sensor); --cfg
configs/campus/jln64.yaml takes the Campus geometry (12 x 12 m, 3
perimeter cameras, 200 x 160 heatmaps) with its wide-baseline rig.  Every
proposal slot is valid (MIN_SCORE -1) and the conv stacks are float32,
on one frame of `structured_heatmaps` (the script's noise with 8 Gaussian
blobs a view), with one set of weights seeded with 0 for all variants.

The variants are the script's list (:97-171), each a set of the config
keys that the port honours (`models/projection.resolve_crop_route`:
SAMPLING_BACKEND, PALLAS_EXACT, PALLAS_FUSED_COORDS, PALLAS_TILE,
PALLAS_WINDOW; COMPUTE_DTYPE), over the script's defaults, plus
`pallas_t444`, a 4 x 4 x 4 tile, which selects the masked-cube route
(kernel row 4) that no variant of the script reaches.  For each variant
the tool prints the route it resolved to (the whole-space sampler is
always `sample_whole_projected`: PALLAS_WHOLE has no CUDA counterpart,
nor do the window sizes and the exact / bf16 product modes of the TPU
kernel), the kernel launches of its forward
(`sampling_kernels.launch_counts`), the largest fused-pose gap to the
'quad' variant (the port's default route: the JAX package's quad path
computes the same function, and the port keeps the default kernel for
it) over the slots whose proposals agree within 0.01 mm, and, unless
--no-timing, ms a frame by the slope between scans of 2 and 10 frames
(`tools.timing.scan_slope`: each scan one CUDA graph, every route
included).  A variant whose keys resolve to the same route as an
earlier one still runs and says "same route as <name>".  The last line is one
JSON object of the readings.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..config import load_config
from ..device import pin_float32, resolve_device
from ..geometry import dome_rig, perimeter_rig
from ..models import build_model
from ..models.projection import resolve_crop_route
from ..ops import sampling_kernels as sk
from .bench import summed
from .timing import device_line, scan_slope

REPO = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_CFG = REPO / "configs" / "panoptic" / "jln64.yaml"
LENGTHS = (2, 10)  # the script's make_runner(2), make_runner(10)

VARIANTS = [
    ("quad", dict(SAMPLING_BACKEND="quad")),
    ("pallas_exact", dict(SAMPLING_BACKEND="pallas", PALLAS_EXACT=True)),
    ("pallas_fast", dict(SAMPLING_BACKEND="pallas", PALLAS_EXACT=False)),
    ("pallas_fast_t888", dict(SAMPLING_BACKEND="pallas", PALLAS_EXACT=False,
                              PALLAS_TILE=(8, 8, 8), PALLAS_WINDOW=(32, 40))),
    ("pallas_fast_t888_w4048", dict(SAMPLING_BACKEND="pallas", PALLAS_EXACT=False,
                                    PALLAS_TILE=(8, 8, 8), PALLAS_WINDOW=(40, 48))),
    ("pallas_fast_t4416", dict(SAMPLING_BACKEND="pallas", PALLAS_EXACT=False,
                               PALLAS_TILE=(4, 4, 16), PALLAS_WINDOW=(24, 48))),
    ("pallas_fast_bf16", dict(SAMPLING_BACKEND="pallas", PALLAS_EXACT=False,
                              COMPUTE_DTYPE="bfloat16")),
    ("pallas_whole", dict(SAMPLING_BACKEND="pallas", PALLAS_EXACT=False, PALLAS_WHOLE=True)),
    ("pallas_prod", dict(SAMPLING_BACKEND="pallas", PALLAS_EXACT=False, PALLAS_TILE=(8, 8, 32),
                         PALLAS_WINDOW=(40, 128), PALLAS_WHOLE=True)),
    ("pallas_fused", dict(SAMPLING_BACKEND="pallas", PALLAS_EXACT=False,
                          PALLAS_TILE=(8, 8, 32), PALLAS_WINDOW=(40, 128),
                          PALLAS_WHOLE=True, PALLAS_FUSED_COORDS=True)),
    ("pallas_fused_exact", dict(SAMPLING_BACKEND="pallas", PALLAS_EXACT=True,
                                PALLAS_TILE=(8, 8, 32), PALLAS_WINDOW=(40, 128),
                                PALLAS_WHOLE=True, PALLAS_FUSED_COORDS=True)),
    ("pallas_fused_w32128", dict(SAMPLING_BACKEND="pallas", PALLAS_EXACT=False,
                                 PALLAS_TILE=(8, 8, 32), PALLAS_WINDOW=(32, 128),
                                 PALLAS_WHOLE=True, PALLAS_FUSED_COORDS=True)),
    ("pallas_fused_w48128", dict(SAMPLING_BACKEND="pallas", PALLAS_EXACT=False,
                                 PALLAS_TILE=(8, 8, 32), PALLAS_WINDOW=(48, 128),
                                 PALLAS_WHOLE=True, PALLAS_FUSED_COORDS=True)),
    ("pallas_fused_w4096", dict(SAMPLING_BACKEND="pallas", PALLAS_EXACT=False,
                                PALLAS_TILE=(8, 8, 32), PALLAS_WINDOW=(40, 96),
                                PALLAS_WHOLE=True, PALLAS_FUSED_COORDS=True)),
    # the port's addition: the masked-cube route (a tile of 64 voxels)
    ("pallas_t444", dict(SAMPLING_BACKEND="pallas", PALLAS_EXACT=False,
                         PALLAS_TILE=(4, 4, 4))),
]
DEFAULTS = dict(
    SAMPLING_BACKEND="quad", PALLAS_EXACT=False,
    PALLAS_WINDOW=(40, 48), PALLAS_TILE=(8, 8, 8),
    PALLAS_WHOLE=False, COMPUTE_DTYPE="float32",
    PALLAS_FUSED_COORDS=False,
)
CROP_KERNEL = {("project", "planes"): "sample_crop_planes",
               ("coords", "planes"): "sample_crop_planes_coords",
               ("project", "cube"): "sample_crop_cube", ("coords", "cube"): "sample_crop_cube"}


def dome_cameras(B, V, seed=100):
    return dome_rig(B, V, seed=seed)


def structured_heatmaps(rng, B, V, H, W, J):
    hm = rng.rand(B, V, H, W, J).astype(np.float32) * 0.2
    yy, xx = np.mgrid[0:H, 0:W]
    for b in range(B):
        for v in range(V):
            for _ in range(8):
                cx_, cy_ = rng.uniform(20, W - 20), rng.uniform(10, H - 10)
                j = rng.randint(J)
                blob = np.exp(
                    -((xx - cx_) ** 2 + (yy - cy_) ** 2) / (2 * 4.0**2)
                )
                hm[b, v, :, :, j] = np.maximum(hm[b, v, :, :, j], blob)
    return hm


def profile_rig(cfg) -> np.ndarray:
    """The (1, V, 21) rig of the profile's geometry: wide-baseline perimeter
    cameras for a space wider than 9 m, a dome otherwise (the script's)."""
    kw = dict(space_center=cfg.CAPTURE_SPEC.SPACE_CENTER,
              ori_image_size=cfg.DATASET.ORI_IMAGE_SIZE)
    if max(cfg.CAPTURE_SPEC.SPACE_SIZE[:2]) > 9000:
        return perimeter_rig(1, cfg.DATASET.CAMERA_NUM, **kw)
    return dome_rig(1, cfg.DATASET.CAMERA_NUM, **kw)


def pose_gap(ref, got):
    """The script's comparison: the share of proposal slots whose centres
    agree within 1e-2, and the largest fused-pose gap (mm) over them."""
    (fq, cq), (fp, cp) = ref, got
    agree = np.all(np.abs(cp[:, :, :3] - cq[:, :, :3]) < 1e-2, axis=-1)
    gap = float(np.abs(fp[agree][:, :, :3] - fq[agree][:, :, :3]).max()) if agree.any() else None
    return float(agree.mean()), gap


def check(cfg_path, device: torch.device, only: Optional[Sequence[str]] = None,
          timing: bool = True, lengths=LENGTHS) -> Dict[str, dict]:
    """{variant: readings}: route, launches, agreement and gap to 'quad',
    ms a frame (with timing)."""
    cfg = load_config(str(cfg_path))
    cfg.CAPTURE_SPEC.MIN_SCORE = -1.0  # all K slots valid: the worst-case load
    cfg.NETWORK.COMPUTE_DTYPE = "float32"
    V = cfg.DATASET.CAMERA_NUM
    W, H = cfg.DATASET.HEATMAP_SIZE
    J = cfg.DATASET.NUM_JOINTS
    rng = np.random.RandomState(0)
    heatmaps = torch.as_tensor(structured_heatmaps(rng, 1, V, H, W, J)).to(device)
    cams = torch.as_tensor(profile_rig(cfg)).to(device)
    variants = [v for v in VARIANTS if not only or v[0] in only]
    weights, seen, out = None, {}, {}
    for name, overrides in variants:
        for k, val in {**DEFAULTS, **overrides}.items():
            setattr(cfg.NETWORK, k, val)
        route = resolve_crop_route(cfg)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = build_model(cfg)
        if weights is None:
            weights = model.state_dict()
        model.load_state_dict(weights)
        model = model.eval().to(device)
        key = (route, cfg.NETWORK.COMPUTE_DTYPE)
        same = seen.setdefault(key, name)
        before = sk.launch_counts()
        with torch.inference_mode():
            res = model(heatmaps, cams)
        launches = {k: n - before[k] for k, n in sk.launch_counts().items() if n != before[k]}
        r = {"route": {"whole": "sample_whole_projected", "crop": CROP_KERNEL[route],
                       "source": route[0], "output": route[1]},
             "dtype": cfg.NETWORK.COMPUTE_DTYPE, "launches": launches,
             "same_route_as": None if same == name else same,
             "outputs": (res.fused_poses.cpu().numpy(), res.proposal_centers.cpu().numpy())}
        tail = f"; same route as {same}" if same != name else ""
        print(f"{name}: route whole sample_whole_projected, crop {CROP_KERNEL[route]} "
              f"{route}, {r['dtype']}, launches {launches}{tail}", flush=True)
        if timing:
            def frames(F):  # the script's make_runner draws each length's frames in turn
                return (torch.as_tensor(rng.rand(F, *heatmaps.shape[1:]).astype(np.float32)
                                        * 0.5).to(device),)

            step = summed(lambda c, x, m=model: m(x[0][None] + c * 1e-30, cams).fused_poses)
            s = scan_slope(step, *lengths, device, frames)
            r.update(ms=s.device_ms if s.device_ms is not None else s.host_ms,
                     host_ms=s.host_ms, device_ms=s.device_ms)
            print(f"{name}: {r['ms']:.4f} ms/frame (heatmaps->poses, K="
                  f"{cfg.CAPTURE_SPEC.MAX_PEOPLE} forced; host {s.host_ms:.4f} ms)", flush=True)
        out[name] = r
    if "quad" in out:
        for name, r in out.items():
            if name == "quad":
                continue
            r["agreement"], r["gap_mm"] = pose_gap(out["quad"]["outputs"], r["outputs"])
            gap = "-" if r["gap_mm"] is None else f"{r['gap_mm']:.4f}"
            print(f"{name} vs quad: proposal agreement {r['agreement']:.3f}, "
                  f"max fused-pose delta {gap} mm")
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cfg", default=str(DEFAULT_CFG))
    p.add_argument("--only", default=None, help="comma-separated variant names")
    p.add_argument("--no-timing", action="store_true")
    p.add_argument("--device", default=None, help="default: the CUDA device (cpu: tests only)")
    p.add_argument("--lengths", default=None, help="F1,F2 in place of 2,10 (tests)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    pin_float32()
    lengths = tuple(int(n) for n in args.lengths.split(",")) if args.lengths else LENGTHS
    only = args.only.split(",") if args.only else None
    out = check(args.cfg, device, only, not args.no_timing, lengths)
    print(device_line(device))
    print(json.dumps({n: {k: v for k, v in r.items() if k != "outputs"} for n, r in out.items()}))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
