"""Where the Campus profile's error lives (counterpart of
scripts/diagnose_campus.py):

    python3 -m faster_voxelpose_tpu_torch.tools.diagnose_campus [--cfg configs/demo/campus_synthetic_ref.yaml] [--device cpu]

Scores the config's best model on its test set (`tools/validate.
evaluate_model`, on the card; the best model under the config's output
directory, else the committed snapshot `checkpoints/<cfg stem>`, as the
JAX package falls back to it) and prints, beside the Panoptic-protocol
table:

- the per-axis error split (`per_axis_split`): mean |dx|, |dy|, |dz| over
  the predictions matched to a person within 500 mm MPJPE; horizontal
  (x, y) errors that dominate point at the image-plane resolution, a
  vertical one at the height net;
- PCP3D(alpha = 0.5), the reference's Campus metric, with predictions and
  the synthetic COCO-17 ground truth both remapped by
  `coco_to_campus_pose`, so that the limbs are the protocol's;
- the PCP per person slot and per limb.

The synthetic scenes have no persistent actors, so the person slots are
the per-frame person indices; the overall PCP is the comparable number.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np


def per_axis_split(preds, gts_list):
    """Mean per-axis abs error over matched (<500mm) predictions."""
    axis_errs = []
    for frame_preds, (gts, gt_vis) in zip(preds, gts_list):
        frame_preds = np.asarray(frame_preds, np.float64)
        valid = frame_preds[:, 0, 3] >= 0
        for gt, vis in zip(gts, gt_vis):
            v = vis > 0.1
            if not v.any() or not valid.any():
                continue
            d = frame_preds[valid][:, v, :3] - gt[None, v]
            mpjpe = np.mean(np.sqrt((d ** 2).sum(-1)), axis=-1)
            best = int(np.argmin(mpjpe))
            if mpjpe[best] < 500.0:
                axis_errs.append(np.mean(np.abs(d[best]), axis=0))
    return np.mean(axis_errs, axis=0), len(axis_errs)


def campus_pcp(preds, gts_list):
    """PCP3D(alpha = 0.5) with the ground truth remapped as the
    predictions are: (average, message, detail)."""
    from ..datasets.evaluate import coco_to_campus_pose, pcp3d_metrics

    actor_gt = [[coco_to_campus_pose(g) for g in gts] for gts, _ in gts_list]
    return pcp3d_metrics(list(preds), actor_gt, coco_to_campus_pose)


def diagnose(preds, records) -> dict:
    """Every reading of the tool on evaluate_model's predictions and the
    test set's records."""
    gts_list = [(r.joints_3d, r.joints_3d_vis) for r in records]
    (ex, ey, ez), n = per_axis_split(preds, gts_list)
    avg_pcp, pcp_msg, detail = campus_pcp(preds, gts_list)
    return {"axis_mm": (float(ex), float(ey), float(ez)), "matched": n,
            "horizontal_mm": float(np.hypot(ex, ey)), "pcp": avg_pcp, "pcp_message": pcp_msg,
            "actor_pcp": [float(v) for v in detail["actor_pcp"]],
            "bone_pcp": {k: float(np.mean(v)) for k, v in detail["bone_pcp"].items()}}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from ..config import load_config
    from ..device import resolve_device
    from ..utils.logging_utils import create_logger
    from .timing import device_line
    from .validate import evaluate_model

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cfg", default="configs/demo/campus_synthetic_ref.yaml")
    p.add_argument("--device", default=None, help="default: the CUDA device (cpu: tests only)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = load_config(args.cfg)
    logger, output_dir, _ = create_logger(cfg, args.cfg, "diagnose")
    metric, msg, preds, test_ds = evaluate_model(cfg, output_dir, logger=logger, device=device,
                                                 repo_snapshot_fallback=True)
    print(msg)
    print(f"panoptic-protocol metric: {metric:.4f}")
    res = diagnose(preds, test_ds.records)
    ex, ey, ez = res["axis_mm"]
    print(f"per-axis error over {res['matched']} matched poses: "
          f"|dx| {ex:.1f}mm  |dy| {ey:.1f}mm  |dz| {ez:.1f}mm  "
          f"(horizontal {res['horizontal_mm']:.1f}mm vs vertical {ez:.1f}mm)")
    print(res["pcp_message"])
    print("PCP3D(alpha=0.5) per person-slot: "
          + "  ".join(f"{v*100:.2f}" for v in res["actor_pcp"]))
    print("per-limb PCP (all slots):")
    for k, v in res["bone_pcp"].items():
        print(f"  {k:12s} {v*100:6.2f}")
    print("reference Campus PCP bar: 96.9 (real data, real heatmaps)")
    print(f"on {device_line(device)}")
    res.update(metric=metric, message=msg)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
