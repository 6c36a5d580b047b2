"""Stage-level timing of the inference pipeline on the card (counterpart of
the JAX package's scripts/profile_stages.py), by the scan slope of
`tools.timing.scan_slope` between 2 and 10 steps:

    python3 -m faster_voxelpose_tpu_torch.tools.profile_stages [TAGS]

TAGS is a comma-separated subset of the script's stage tags (default all):

    0   backbone: ResNet-50 over V images at the config's IMAGE_SIZE, the
        config's own compute dtype (bf16 as served)
    2   whole-space projection (kernel row 1, `sample_whole_projected`)
    3   HDN total: projection, CenterNet, NMS/top-K, C2CNet, proposals
    4   JLN crop and max planes of K crops, all valid (kernel row 2)
    6   full model, heatmaps -> poses
    7   CenterNet   8 C2CNet, then nms2d_topk   9 P2PNet   10 WeightNet
    11  soft-argmax

The configs/panoptic/jln64.yaml profile with MIN_SCORE -1 and float32
conv stacks for stages 2-6 (the script's parity config), seeded random
weights, uniform heatmaps in [0, 0.5) on a dome rig; stages 0 and 7-10 run
in the config's own dtype, as the script's.  Each stage's input gets 1e-30
of the carry and its output's sum feeds the carry, as in the script.

The script's Pallas ablations (1 the quad table; 4b-4i coordinates, block
specs and the kernel's epilogue; 5 the Pallas whole-space kernel against
the quad path) take the TPU kernel apart and are not ported: each CUDA
kernel's own time, plain version, library call and bound are kernel rows
1-2 of chip_smoke.py.  Prints one JSON line {stage: {"host_ms",
"device_ms"}} after the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import pin_float32, resolve_device
from ..geometry import dome_rig
from ..models import build_model
from ..models.cnns import C2CNet, CenterNet, P2PNet, WeightNet
from ..models.faster_voxelpose import DTYPES
from ..models.projection import (CropConstants, compute_crop_origin,
                                 project_individual_planes, project_whole_batch)
from ..models.resnet import build_backbone
from ..ops import sampling_kernels as sk
from ..ops.nms import nms2d_topk
from ..ops.soft_argmax import soft_argmax
from .bench import WORST_CASE_CFG, seeded
from .timing import device_line, scan_slope

LENGTHS = (2, 10)  # the script's slope(n1=2, n2=10)
TAGS = ("0", "2", "3", "4", "6", "7", "8", "9", "10", "11")

Stage = Tuple[Callable[[torch.Tensor], torch.Tensor], torch.Tensor]


def stages(cfg_path, device: torch.device, tags: Optional[Sequence[str]] = None
           ) -> Dict[str, Stage]:
    """{name: (fn, input)} of the stages whose tags are in `tags` (all by
    default), on inputs of the script's shapes drawn from RandomState(0)."""
    from ..config import load_config

    want = (lambda t: True) if tags is None else (lambda t: t in tags)
    served = load_config(cfg_path)
    cfg = load_config(cfg_path)
    cfg.CAPTURE_SPEC.MIN_SCORE = -1.0
    cfg.NETWORK.COMPUTE_DTYPE = "float32"
    V, J = cfg.DATASET.CAMERA_NUM, cfg.DATASET.NUM_JOINTS
    W, H = cfg.DATASET.HEATMAP_SIZE
    K = cfg.CAPTURE_SPEC.MAX_PEOPLE
    vx, vy, vz = cfg.CAPTURE_SPEC.VOXELS_PER_AXIS
    cx, cy, _ = cfg.INDIVIDUAL_SPEC.VOXELS_PER_AXIS
    dt = DTYPES[served.NETWORK.COMPUTE_DTYPE]
    rng = np.random.RandomState(0)

    def on(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32).to(device)

    hm = on(rng.rand(1, V, H, W, J) * 0.5)
    cams = on(dome_rig(1, V))
    model = seeded(build_model, cfg, 0, device)
    geom = model.geom
    out: Dict[str, Stage] = {}
    if want("0"):
        iw, ih = served.DATASET.IMAGE_SIZE
        backbone = seeded(build_backbone, served, 0, device)
        out["backbone"] = (lambda a: backbone(a)[:, 0, 0, 0], on(rng.rand(V, ih, iw, 3)))
    hdn = model.hdn
    axes = (hdn.whole_gx, hdn.whole_gy, hdn.whole_gz)
    if want("2"):
        out["whole_projection"] = (
            lambda a: project_whole_batch(geom, a, cams, axes)[:, 0, 0, 0, 0], hm)
    if want("3"):
        out["hdn"] = (lambda a: hdn(a, cams).proposal_centers, hm)
    centers = rng.uniform(-1200, 1200, (1, K, 3)).astype(np.float32)
    centers[..., 2] = rng.uniform(600, 1100, (1, K))
    tl, _ = compute_crop_origin(geom, on(centers))
    bbox = on(rng.uniform(0.4, 0.9, (1, K, 2)))
    valid = torch.ones((K,), dtype=torch.bool, device=device)
    route = model.jln.crop_route
    # the crop constants the JLN holds on the device (none copied from the
    # host inside a graph)
    consts = CropConstants(*(getattr(model.jln, f"crop_{f}") for f in CropConstants._fields))
    if want("4"):
        out["jln_planes"] = (lambda a: project_individual_planes(
            geom, a[0], cams[0], tl[0], bbox[0], valid, route, consts)[0][:, 0, 0, 0], hm)
    if want("6"):
        out["full_model"] = (lambda a: model(a, cams).fused_poses[..., 0], hm)
    heads = {}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        if want("7"):
            heads["center_net"] = (CenterNet(J, dtype=dt), rng.rand(1, vx, vy, vz, J),
                                   lambda m, a: m(a)[0][:, 0])
        if want("8"):
            cols = rng.rand(K, vz, J).transpose(0, 2, 1)  # (K, J, Z): the port's layout
            heads["c2c_net"] = (C2CNet(J, dtype=dt), cols, lambda m, a: m(a))
            out["nms2d_topk"] = (lambda a: nms2d_topk(a, K)[0], on(rng.rand(1, vx, vy)))
        n3 = 3 * K  # three planes of K people, batch 1
        if want("9"):
            heads["p2p_net"] = (P2PNet(J, J, dtype=dt), rng.rand(n3, cx, cy, J).transpose(0, 3, 1, 2),
                                lambda m, a: m(a))
        if want("10"):
            heads["weight_net"] = (WeightNet(dtype=dt), rng.rand(n3, cx, cy, J).transpose(0, 3, 1, 2),
                                   lambda m, a: m(a))
    for name, (module, x, call) in heads.items():
        module = module.eval().to(device)
        out[name] = ((lambda a, m=module, c=call: c(m, a)), on(x))
    if want("11"):
        grids = model.jln.center_grids
        beta = cfg.NETWORK.BETA
        out["soft_argmax"] = (lambda a: soft_argmax(a, grids, beta)[0],
                              on(rng.rand(3, K, J, cx * cy)))
    return out


def stage_step(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor):
    """The script's scan body: the stage on its input plus 1e-30 of the
    carry; its output's sum, times 1e-30, the next carry and the output."""

    def step(carry, _):
        ss = fn(x + carry * 1e-30).float().sum() * 1e-30
        return ss, ss

    return step


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Per-stage scan-slope timing of the pipeline")
    p.add_argument("tags", nargs="?", default=None, help="comma-separated stage tags")
    p.add_argument("--device", default=None, help="default: the CUDA device (cpu: tests only)")
    p.add_argument("--cfg", default=str(WORST_CASE_CFG))
    p.add_argument("--lengths", default=None, help="F1,F2 in place of 2,10 (tests)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    pin_float32()
    n1, n2 = tuple(int(n) for n in args.lengths.split(",")) if args.lengths else LENGTHS
    tags = None if args.tags is None else args.tags.split(",")
    unknown = set(tags or ()) - set(TAGS)
    if unknown:
        raise SystemExit(f"unknown stage tags {sorted(unknown)}; known: {', '.join(TAGS)}")
    sk.reset_launch_counts()
    times = {}
    for name, (fn, x) in stages(args.cfg, device, tags).items():
        s = scan_slope(stage_step(fn, x), n1, n2, device)
        times[name] = {"host_ms": s.host_ms, "device_ms": s.device_ms}
    print(device_line(device))
    print(f"kernel launches: {json.dumps(sk.launch_counts())}")
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
