"""Evaluation of a committed snapshot on the held-out synthetic scenes of
its own profile (the synthetic-profile counterpart of run/validate.py):

    python3 -m faster_voxelpose_tpu_torch.tools.validate [--checkpoint DIR] [--scenes N] [--device cpu]

DIR (default checkpoints/panoptic_synthetic) holds model_best.npz and
eval_record.json.  The record's `config` names the profile by its file
stem (`config.profile`; a record may hold the path absolute or relative,
only the stem is read).  The held-out scenes are that profile's
SYNTHETIC.NUM_DATA scenes (seed TRAIN.SEED + 10007) on the rig and pose
bank of its `make_demo_data.py` line (`datasets/demo_data.py`:
`demo_rig`, `demo_pose_bank`), made here from seeds.  Prints the Panoptic
metric table beside the record's, with the card's name and power limit.
The scene generator draws in sequence, so `--scenes N` evaluates the
first N of the record's scenes.  `round_head_sums` on a loaded model,
passed as `evaluate_snapshot(model=...)`, scores it with the heads' last
layers rounded to bf16, as the JAX package's CPU arithmetic does, where
the port keeps them in float32 (`models/blocks.py`, `Conv`): a control
for that one departure.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from typing import Optional, Sequence

from ..config import Config, profile
from ..datasets import SyntheticDataset
from ..datasets.demo_data import demo_pose_bank, demo_rig
from ..device import resolve_device
from ..engine.checkpoint import load_best_npz
from ..engine.validator import run_validation
from ..models.faster_voxelpose import build_model
from .timing import device_line

REPO = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_CHECKPOINT = REPO / "checkpoints" / "panoptic_synthetic"


def read_record(checkpoint: pathlib.Path) -> Optional[dict]:
    """The snapshot's eval_record.json, or None where it has none."""
    path = pathlib.Path(checkpoint) / "eval_record.json"
    return json.loads(path.read_text()) if path.exists() else None


def snapshot_profile(checkpoint: pathlib.Path) -> Config:
    """The profile of the config the snapshot's record names, by stem."""
    record = read_record(checkpoint)
    if record is None:
        raise FileNotFoundError(f"{checkpoint} has no eval_record.json to name its profile")
    return profile(record["config"])


def round_head_sums(model, keep=()) -> list:
    """Round the float32 sums of the model's head layers (`blocks.Conv` and
    `Dense` with `float32_out`) to the compute dtype, except the layers
    whose own name is in `keep` (e.g. "hm_out", the centre heatmap's);
    returns the names of the layers rounded."""
    rounded = []
    for name, m in model.named_modules():
        if getattr(m, "out_dtype", None) not in (None, getattr(m, "dtype", None)) \
                and name.rsplit(".", 1)[-1] not in keep:
            m.out_dtype = m.dtype
            rounded.append(name)
    return rounded


def held_out_dataset(cfg: Config, scenes: Optional[int] = None) -> SyntheticDataset:
    """The held-out synthetic scenes of `cfg` on its demo rig and pose
    bank, the first `scenes` of them (default SYNTHETIC.NUM_DATA)."""
    if scenes is not None:
        cfg.SYNTHETIC.NUM_DATA = scenes
    return SyntheticDataset(cfg, is_train=False, pose_bank=demo_pose_bank(cfg),
                            cameras=demo_rig(cfg))


def evaluate_snapshot(checkpoint: pathlib.Path = DEFAULT_CHECKPOINT, scenes: Optional[int] = None,
                      device=None, model=None) -> dict:
    """Score checkpoint/model_best.npz on the held-out scenes of its
    profile; returns metric, message, the people detected and the people
    there are, frames per second (scene generation excluded, sample making
    included), the profile and the snapshot's eval record.  `model` takes
    an already loaded model of the profile in place of the checkpoint's."""
    checkpoint = pathlib.Path(checkpoint)
    device = resolve_device(device)
    cfg = snapshot_profile(checkpoint)
    if model is None:
        model = load_best_npz(str(checkpoint / "model_best.npz"), build_model(cfg))
    t0 = time.perf_counter()
    dataset = held_out_dataset(cfg, scenes)
    t1 = time.perf_counter()
    metric, msg, preds = run_validation(cfg, model, dataset, device=device)
    t2 = time.perf_counter()
    return dict(metric=metric, message=msg, scenes=len(dataset), scene_s=t1 - t0,
                eval_s=t2 - t1, frames_per_s=len(dataset) / (t2 - t1),
                record=read_record(checkpoint), preds=preds, device=device, cfg=cfg,
                detected=int((preds[:, :, 0, 3] >= 0).sum()),
                people=sum(len(rec.joints_3d) for rec in dataset.records))


def metric_table(message: str) -> dict:
    """{'ap@50': 0.8668, ...} from a Panoptic metric message."""
    import re

    return {k: float(v) for k, v in re.findall(r"(\S+@\S+): ([0-9.]+)", message)}


def side_by_side(message: str, record_message: str) -> str:
    """The port's metric table beside the record's, one metric a line."""
    got, rec = metric_table(message), metric_table(record_message)
    lines = [f"{'metric':<14}{'port':>10}{'record':>10}{'port - record':>16}"]
    lines += [f"{k:<14}{got[k]:>10.4f}{rec[k]:>10.4f}{got[k] - rec[k]:>+16.4f}"
              for k in got if k in rec]
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scenes", type=int, default=None,
                   help="evaluate the first N held-out scenes (default: the profile's NUM_DATA)")
    p.add_argument("--checkpoint", type=pathlib.Path, default=DEFAULT_CHECKPOINT,
                   help="directory holding model_best.npz and eval_record.json")
    p.add_argument("--device", default=None, help="'cpu' runs the plain PyTorch path")
    args = p.parse_args(argv)
    res = evaluate_snapshot(args.checkpoint, args.scenes, args.device)
    d = res["cfg"].DATASET
    print(f"{args.checkpoint.name}: profile {pathlib.PurePath(res['record']['config']).stem}, "
          f"{d.CAMERA_NUM} views, {d.NUM_JOINTS} joints, K = {res['cfg'].CAPTURE_SPEC.MAX_PEOPLE}")
    print(res["message"])
    print(f"metric: {res['metric']:.4f}, {res['detected']} people detected where there are "
          f"{res['people']}")
    print(f"{res['scenes']} scenes generated in {res['scene_s']:.1f} s, evaluated in "
          f"{res['eval_s']:.1f} s ({res['frames_per_s']:.3f} frames/s, sample making on the host "
          f"included) | {device_line(res['device'])}")
    rec = res["record"]
    print(f"the snapshot's record ({rec.get('eval_set', 'its own eval set')}), metric "
          f"{rec['metric']:.4f}:\n{side_by_side(res['message'], rec['message'])}")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
