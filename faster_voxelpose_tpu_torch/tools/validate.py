"""Evaluation of a snapshot on the held-out synthetic scenes of the
Panoptic profile (the synthetic-profile counterpart of run/validate.py):

    python3 -m faster_voxelpose_tpu_torch.tools.validate [--scenes N] [--checkpoint DIR] [--device cpu]

Builds the demo rig and pose bank of configs/demo/panoptic_synthetic.yaml
from seeds (`datasets/demo_data.py`: make_rig(5, 2800, 2200, (0, -500),
(1920, 1080)) and make_pose_bank(2000, skeleton="panoptic15")), takes the
config from `panoptic_synthetic_profile()`, loads DIR/model_best.npz
(default checkpoints/panoptic_synthetic), generates the held-out scenes
(seed TRAIN.SEED + 10007) and prints the Panoptic metric table with the
card's name and power limit, beside the snapshot's own eval_record.json
where there is one.  The scene generator draws in sequence, so
`--scenes N` evaluates the first N of the record's 5000 scenes.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from typing import Optional, Sequence

import numpy as np

from ..config import Config, panoptic_synthetic_profile
from ..datasets import SyntheticDataset
from ..datasets.demo_data import make_pose_bank, make_rig
from ..device import resolve_device
from ..engine.checkpoint import load_best_npz
from ..engine.validator import run_validation
from ..models.faster_voxelpose import build_model
from .timing import device_line

REPO = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_CHECKPOINT = REPO / "checkpoints" / "panoptic_synthetic"


def held_out_dataset(cfg: Config, scenes: Optional[int] = None) -> SyntheticDataset:
    """The held-out synthetic scenes of `cfg` on the demo rig and pose
    bank, the first `scenes` of them (default SYNTHETIC.NUM_DATA)."""
    d = cfg.DATASET
    rig = make_rig(d.CAMERA_NUM, 2800.0, 2200.0, cfg.CAPTURE_SPEC.SPACE_CENTER[:2], d.ORI_IMAGE_SIZE)
    cams = {int(k): {kk: np.array(vv) for kk, vv in v.items()} for k, v in rig.items()}
    if scenes is not None:
        cfg.SYNTHETIC.NUM_DATA = scenes
    return SyntheticDataset(cfg, is_train=False, pose_bank=make_pose_bank(2000), cameras=cams)


def evaluate_snapshot(checkpoint: pathlib.Path = DEFAULT_CHECKPOINT, scenes: Optional[int] = None,
                      device=None, model=None) -> dict:
    """Score checkpoint/model_best.npz on the held-out scenes; returns
    metric, message, the people detected and the people there are, frames
    per second (scene generation excluded, sample making included) and the
    snapshot's eval record if it has one.  `model` takes an already loaded
    model of the profile in place of the checkpoint's."""
    device = resolve_device(device)
    cfg = panoptic_synthetic_profile()
    if model is None:
        model = load_best_npz(str(checkpoint / "model_best.npz"), build_model(cfg))
    t0 = time.perf_counter()
    dataset = held_out_dataset(cfg, scenes)
    t1 = time.perf_counter()
    metric, msg, preds = run_validation(cfg, model, dataset, device=device)
    t2 = time.perf_counter()
    record_path = checkpoint / "eval_record.json"
    record = json.loads(record_path.read_text()) if record_path.exists() else None
    return dict(metric=metric, message=msg, scenes=len(dataset), scene_s=t1 - t0,
                eval_s=t2 - t1, frames_per_s=len(dataset) / (t2 - t1), record=record,
                preds=preds, device=device, detected=int((preds[:, :, 0, 3] >= 0).sum()),
                people=sum(len(rec.joints_3d) for rec in dataset.records))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scenes", type=int, default=None,
                   help="evaluate the first N held-out scenes (default: all 5000)")
    p.add_argument("--checkpoint", type=pathlib.Path, default=DEFAULT_CHECKPOINT,
                   help="directory holding model_best.npz")
    p.add_argument("--device", default=None, help="'cpu' runs the plain PyTorch path")
    args = p.parse_args(argv)
    res = evaluate_snapshot(args.checkpoint, args.scenes, args.device)
    print(res["message"])
    print(f"metric: {res['metric']:.4f}, {res['detected']} people detected where there are "
          f"{res['people']}")
    print(f"{res['scenes']} scenes generated in {res['scene_s']:.1f} s, evaluated in "
          f"{res['eval_s']:.1f} s ({res['frames_per_s']:.3f} frames/s, sample making on the host "
          f"included) | {device_line(res['device'])}")
    if res["record"] is not None:
        print(f"the snapshot's record ({res['record'].get('eval_set', 'its own eval set')}):\n"
              f"{res['record']['message']}\nmetric: {res['record']['metric']:.4f}")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
