"""Streaming inference demo of the port (counterpart of run/demo.py): a
config, a flat {cam_id: {R, T, fx, fy, cx, cy, k, p}} calibration file
and one image per view in, 3D poses out:

    python3 -m faster_voxelpose_tpu_torch.tools.demo --cfg demo/config.yaml \\
        --calibration demo/calibration.json --images v0.jpg v1.jpg v2.jpg v3.jpg v4.jpg \\
        --torch-weights model_best.pth.tar [--backbone-weights pose_resnet.pth] \\
        [--out demo_out] [--repeat N] [--device cpu]

Built on `PoseService`: the rig comes from the calibration
(`set_rig_from_calibration`, the first CAMERA_NUM cameras in id order),
the frames are decoded and warped to IMAGE_SIZE on the host and sent as
uint8, and the whole image path (normalisation, backbone, fusion) replays
from the service's captured 'images_u8' graph, as the JAX demo runs one
jit.  Writes `fused_poses.npy` (K, J, 5), then `demo_2d_planes.png`
(which needs matplotlib, as the JAX demo's does) into --out.
`--repeat N` answers the frame N more times and prints the
steady-state latency from the service's own timings.  Weights: an
upstream FasterVoxelPoseNet checkpoint (--torch-weights) and Pose-ResNet
(--backbone-weights, else NETWORK.PRETRAINED_BACKBONE); without them a
random init from seed 0, which is not the JAX package's random init.
Runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

import numpy as np

from ..config import load_config
from ..datasets.images import load_view_images_u8
from ..engine.service import PoseService
from ..geometry.transforms import get_resize_transform
from ..ops import sampling_kernels as sk
from ..utils.vis import save_2d_planes
from ..weights import convert_backbone, convert_model, load_torch_state_dict, to_jax_variables


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Faster-VoxelPose streaming demo (PyTorch/CUDA port)")
    p.add_argument("--cfg", required=True)
    p.add_argument("--calibration", required=True, help="flat {cam_id: {...}} json")
    p.add_argument("--images", nargs="+", required=True, help="one image per view")
    p.add_argument("--torch-weights", default=None)
    p.add_argument("--backbone-weights", default=None)
    p.add_argument("--out", default="demo_out")
    p.add_argument("--repeat", type=int, default=1, help="re-run for latency stats")
    p.add_argument("--device", default=None, help="'cpu' runs the plain PyTorch path")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    cfg = load_config(args.cfg)
    d = cfg.DATASET
    if len(args.images) != d.CAMERA_NUM:
        raise SystemExit(f"need {d.CAMERA_NUM} views, got {len(args.images)} images")
    variables = backbone_variables = None
    if args.torch_weights:
        variables = to_jax_variables(convert_model(load_torch_state_dict(args.torch_weights)))
    backbone_path = args.backbone_weights or cfg.NETWORK.PRETRAINED_BACKBONE
    if backbone_path:
        backbone_variables = to_jax_variables(
            convert_backbone(load_torch_state_dict(backbone_path), cfg.RESNET.NUM_LAYERS))
    svc = PoseService(cfg, variables, backbone_variables, device=args.device, aot=False)
    svc.set_rig_from_calibration(args.calibration)
    svc.warmup(("images_u8",))
    frames = load_view_images_u8(list(args.images), d.IMAGE_SIZE,
                                 get_resize_transform(d.ORI_IMAGE_SIZE, d.IMAGE_SIZE))
    svc.infer_images(frames)
    if args.repeat > 1:
        ms = [svc.infer_images(frames)["latency_ms"] for _ in range(args.repeat)]
        dt = float(np.mean(ms))
        print(f"steady-state latency: {dt:.2f} ms/frame ({1e3 / dt:.1f} fps)")
    fused, centers = (a[0] for a in svc.infer_images_raw(frames))
    print(f"detected {int((fused[:, 0, 3] >= 0).sum())} people")
    print(f"kernel launches: {json.dumps(sk.launch_counts())}")
    os.makedirs(args.out, exist_ok=True)
    np.save(os.path.join(args.out, "fused_poses.npy"), fused)
    path = save_2d_planes(cfg, fused, centers, os.path.join(args.out, "demo"))
    print("wrote", path)
    return dict(fused=fused, centers=centers, stats=svc.stats(), vis=path)


if __name__ == "__main__":
    main(sys.argv[1:])
