"""Evaluation CLI of the port (counterpart of run/validate.py), in two
modes:

    python3 -m faster_voxelpose_tpu_torch.tools.validate --cfg configs/shelf/jln64.yaml \
        [--torch-weights model_best.pth.tar] [--profile DIR] [--device cpu]
    python3 -m faster_voxelpose_tpu_torch.tools.validate [--checkpoint DIR] [--scenes N] [--device cpu]

`--cfg` evaluates the config's TEST_DATASET (synthetic, Panoptic, Shelf
or Campus, any heatmap source) with its best model
(`<OUTPUT_DIR>/<TEST_DATASET>/<cfg stem>/model_best.npz`, else the
repository's snapshot `checkpoints/<cfg stem>`, as the JAX CLI falls back
to it; the file loaded is logged) or with an upstream checkpoint
(`--torch-weights`), prints the metric table and `metric: x.xxxx`, and
with TEST.VISUALIZATION draws the first 20 predictions into
`<output_dir>/validation_vis`; `--profile DIR` writes a torch.profiler
trace of the evaluation.  `evaluate_model` is its importable core, with
the JAX function's signature.

`--checkpoint` (the default mode) scores a committed snapshot on the
held-out synthetic scenes of its own profile.  DIR (default
checkpoints/panoptic_synthetic) holds model_best.npz and
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
import copy
import json
import logging
import os
import pathlib
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import Config, load_config, profile
from ..datasets import SyntheticDataset, get_dataset
from ..datasets.demo_data import demo_pose_bank, demo_rig
from ..datasets.images import load_view_images_u8
from ..device import resolve_device
from ..engine.checkpoint import load_best_model, load_best_npz
from ..engine.loader import DatasetFactory
from ..engine.validator import run_validation
from ..models.faster_voxelpose import build_model
from ..models.resnet import build_backbone
from ..ops import sampling_kernels as sk
from ..ops.heatmap_render import render_heatmaps_device
from ..utils.logging_utils import create_logger
from ..utils.profiling import trace
from ..weights import convert_backbone, convert_model, load_torch_state_dict
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


class HeldOutFactory:
    """Picklable maker of `held_out_dataset(cfg, scenes)`, for the
    loader's spawn workers (`engine.loader.DataLoader`'s
    dataset_factory): each worker generates the same scenes from the
    seed."""

    def __init__(self, cfg: Config, scenes: Optional[int] = None):
        self.cfg, self.scenes = cfg, scenes

    def __call__(self) -> SyntheticDataset:
        return held_out_dataset(copy.deepcopy(self.cfg), self.scenes)


def evaluate_snapshot(checkpoint: pathlib.Path = DEFAULT_CHECKPOINT, scenes: Optional[int] = None,
                      device=None, model=None, workers: int = 0,
                      device_render: Optional[bool] = None,
                      augmentation: Optional[bool] = None) -> dict:
    """Score checkpoint/model_best.npz on the held-out scenes of its
    profile; returns metric, message, the people detected and the people
    there are, frames per second (scene generation excluded, sample making
    included), the profile and the snapshot's eval record.  `model` takes
    an already loaded model of the profile in place of the checkpoint's.
    `workers` > 0 makes the samples in that many spawn processes;
    `device_render` and `augmentation`, where given, set the profile's
    DATASET.DEVICE_RENDER (false: heatmaps rendered on the host) and
    SYNTHETIC.DATA_AUGMENTATION (the loader's workers draw their own
    augmentation, so only a reading without it is the same in and out of
    workers)."""
    checkpoint = pathlib.Path(checkpoint)
    device = resolve_device(device)
    cfg = snapshot_profile(checkpoint)
    if device_render is not None:
        cfg.DATASET.DEVICE_RENDER = device_render
    if augmentation is not None:
        cfg.SYNTHETIC.DATA_AUGMENTATION = augmentation
    if model is None:
        model = load_best_npz(str(checkpoint / "model_best.npz"), build_model(cfg))
    t0 = time.perf_counter()
    dataset = held_out_dataset(cfg, scenes)
    t1 = time.perf_counter()
    metric, msg, preds = run_validation(
        cfg, model, dataset, device=device,
        dataset_factory=HeldOutFactory(cfg, scenes) if workers else None, num_workers=workers)
    t2 = time.perf_counter()
    return dict(metric=metric, message=msg, scenes=len(dataset), scene_s=t1 - t0,
                eval_s=t2 - t1, frames_per_s=len(dataset) / (t2 - t1),
                record=read_record(checkpoint), preds=preds, device=device, cfg=cfg,
                detected=int((preds[:, :, 0, 3] >= 0).sum()),
                people=sum(len(rec.joints_3d) for rec in dataset.records))


def evaluate_model(cfg: Config, output_dir: str, torch_weights: Optional[str] = None,
                   weights_mode: str = "best", test_ds=None, logger=None, device=None,
                   repo_snapshot_fallback: bool = False):
    """The config's test set scored with one of three weight sources
    (counterpart of run/validate.py's `evaluate_model`): `torch_weights`,
    an upstream FasterVoxelPoseNet checkpoint, overrides `weights_mode`,
    which is 'best' (`<output_dir>/model_best.npz`; with
    `repo_snapshot_fallback`, else the repository's
    `checkpoints/<basename of output_dir>`) or 'random' (a model
    initialised from seed 0, a dry run of the pipeline).  With
    TEST_HEATMAP_SRC 'image' the backbone is NETWORK.PRETRAINED_BACKBONE
    and the frames come from the records' image files.  Returns (metric,
    message, preds (N, K, J, 5), test_ds)."""
    if weights_mode not in ("best", "random"):
        raise ValueError(f"weights_mode {weights_mode!r}: 'best' or 'random'")
    logger = logger or logging.getLogger(__name__)
    if test_ds is None:
        test_ds = get_dataset(cfg.DATASET.TEST_DATASET)(cfg, is_train=False)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(cfg)
    if torch_weights:
        model.load_state_dict(convert_model(load_torch_state_dict(torch_weights), model))
        logger.info("=> converted torch weights from %s", torch_weights)
    elif weights_mode == "random":
        logger.info("=> evaluating RANDOM init (pipeline dry run)")
    else:
        load_best_model(output_dir, model, repo_snapshot_fallback=repo_snapshot_fallback)

    backbone = image_loader = None
    if cfg.DATASET.TEST_HEATMAP_SRC == "image":
        if not cfg.NETWORK.PRETRAINED_BACKBONE:
            raise ValueError("TEST_HEATMAP_SRC 'image' needs NETWORK.PRETRAINED_BACKBONE")
        backbone = build_backbone(cfg)
        backbone.load_state_dict(convert_backbone(
            load_torch_state_dict(cfg.NETWORK.PRETRAINED_BACKBONE), cfg.RESNET.NUM_LAYERS,
            backbone))

        def image_loader(idxs):  # uint8 frames, normalised on the device
            return np.stack([load_view_images_u8(test_ds.records[i].image_paths,
                                                 cfg.DATASET.IMAGE_SIZE, test_ds.resize_transform)
                             for i in idxs])

    metric, msg, preds = run_validation(
        cfg, model, test_ds, device=device, backbone=backbone, image_loader=image_loader,
        dataset_factory=DatasetFactory(cfg.DATASET.TEST_DATASET, cfg, False)
        if cfg.WORKERS > 0 else None)
    return metric, msg, preds, test_ds


def _sample_heatmaps(cfg: Config, sample: dict) -> np.ndarray:
    """A sample's (V, H, W, J) input heatmaps, rendered on the host from
    its Gaussians' parameters where the dataset renders on the device."""
    if "input_heatmaps" in sample:
        return sample["input_heatmaps"]
    W, H = cfg.DATASET.HEATMAP_SIZE
    return render_heatmaps_device(torch.as_tensor(sample["hm_params"]), H, W).numpy()


def validation_vis(cfg: Config, test_ds, preds: np.ndarray, output_dir: str) -> list:
    """TEST.VISUALIZATION: every VIS_TYPE artifact of the first 20
    predictions into `<output_dir>/validation_vis` (the inputs of
    run/validate.py: the samples' heatmaps unless the source is 'image',
    the records' original frames where every view's file reads); returns
    the files written."""
    from ..utils.vis import test_vis_all

    idxs = range(min(len(preds), 20))
    heatmaps = images = rigs = None
    if "heatmaps" in cfg.TEST.VIS_TYPE and cfg.DATASET.TEST_HEATMAP_SRC != "image":
        heatmaps = np.stack([_sample_heatmaps(cfg, test_ds[i]) for i in idxs])
    if "image_with_poses" in cfg.TEST.VIS_TYPE:
        import cv2

        loaded = [[cv2.imread(p, cv2.IMREAD_COLOR) for p in (test_ds.records[i].image_paths or [])]
                  for i in idxs]
        if all(v and all(im is not None for im in v) for v in loaded):
            images = loaded
            rigs = np.stack([test_ds[i]["cameras"] for i in idxs])
    return test_vis_all(cfg, None, preds[:len(idxs)], None, heatmaps,
                        os.path.join(output_dir, "validation_vis", "val"),
                        images=images, packed_rigs=rigs, resize_transform=None)


def validate_config(args: argparse.Namespace) -> dict:
    """The --cfg mode: run/validate.py's main."""
    cfg = load_config(args.cfg)
    logger, output_dir, _ = create_logger(cfg, args.cfg, "validate")
    device = resolve_device(args.device)
    logger.info("device: %s", device_line(device))
    with trace(args.profile):
        metric, msg, preds, test_ds = evaluate_model(
            cfg, output_dir, torch_weights=args.torch_weights, logger=logger, device=device,
            repo_snapshot_fallback=True)
    if args.profile:
        logger.info("wrote profiler trace to %s", args.profile)
    print(msg)
    print(f"metric: {metric:.4f}")
    vis = []
    if cfg.TEST.VISUALIZATION:
        vis = validation_vis(cfg, test_ds, preds, output_dir)
        logger.info("wrote %d visualizations to %s", len(vis),
                    os.path.join(output_dir, "validation_vis"))
    logger.info("kernel launches: %s", json.dumps(sk.launch_counts()))
    return dict(metric=metric, message=msg, preds=preds, output_dir=output_dir, vis=vis)


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


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--cfg", help="experiment yaml: score its TEST_DATASET")
    mode.add_argument("--checkpoint", type=pathlib.Path, default=DEFAULT_CHECKPOINT,
                      help="directory holding model_best.npz and eval_record.json")
    p.add_argument("--torch-weights", default=None,
                   help="with --cfg: evaluate an upstream checkpoint (model_best.pth.tar)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="with --cfg: write a torch.profiler trace of the evaluation into DIR")
    p.add_argument("--scenes", type=int, default=None,
                   help="with --checkpoint: evaluate the first N held-out scenes "
                        "(default: the profile's NUM_DATA)")
    p.add_argument("--device", default=None, help="'cpu' runs the plain PyTorch path")
    args = p.parse_args(argv)
    if args.cfg is None and (args.torch_weights or args.profile):
        p.error("--torch-weights and --profile go with --cfg")
    if args.cfg is not None and args.scenes is not None:
        p.error("--scenes goes with --checkpoint")
    return args


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    if args.cfg is not None:
        return validate_config(args)
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
