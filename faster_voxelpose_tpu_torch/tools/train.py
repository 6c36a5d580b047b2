"""Training CLI of the port (counterpart of run/train.py):

    python -m faster_voxelpose_tpu_torch.tools.make_demo_data --out data/DemoPanoptic \\
        --views 5 --poses 2000 --skeleton panoptic15 --center 0 -500 --radius 2800 \\
        --image-size 1920 1080
    python -m faster_voxelpose_tpu_torch.tools.train --cfg configs/demo/panoptic_synthetic.yaml \\
        --snapshot-dir /tmp/snapshots/panoptic_synthetic

Config-driven dataset and model construction, a frozen backbone where a
heatmap source is 'image', the two optimizers of `engine.trainer` in a
train step captured into a CUDA graph (`--eager`: none), samples made
and uploaded ahead of the step by `engine.loader.prefetch_to_device`,
validation every `--eval-every` epochs (and after the last) with
best-model tracking, with TRAIN.VISUALIZATION the artifacts of
`utils/vis.train_vis_all` on every PRINT_FREQ-th batch (an eval-mode
forward of the current weights after the step, outside its graph, into
`<output dir>/train_vis/<epoch>_<batch>`), and a resumable checkpoint every epoch
(`<OUTPUT_DIR>/<TEST_DATASET>/<cfg stem>/checkpoint.pt`; `--resume`
continues it, the loader's order and augmentation draws included).

Each new best writes `model_best.npz` and `eval_record.json` into
`--snapshot-dir`, by default the JAX package's place for them,
`checkpoints/<cfg stem>` in this repository, which overwrites the
committed snapshot of that name: pass `--snapshot-dir` for any run that
should leave the repository as it is.  The record names the config by
its path relative to the repository where the file lies inside it.

Runs on the CUDA device unless `--device cpu` is given, and raises
without one.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import Config, load_config
from ..datasets import get_dataset
from ..datasets.images import denormalize_images
from ..device import pin_float32, resolve_device
from ..engine.checkpoint import load_checkpoint, save_checkpoint, write_repo_snapshot
from ..engine.loader import DataLoader, DatasetFactory, prefetch_to_device
from ..engine.trainer import AverageMeter, Trainer
from ..engine.validator import run_validation
from ..models.faster_voxelpose import build_model
from ..models.resnet import build_backbone
from ..ops import sampling_kernels as sk
from ..utils.bench_lock import wait_if_bench_locked
from ..utils.logging_utils import ScalarWriter, create_logger
from ..weights import convert_backbone, load_torch_state_dict

REPO = pathlib.Path(__file__).resolve().parents[2]
LOSS_KEYS = (("total", "total"), ("2d_heatmaps", "2d"), ("1d_heatmaps", "1d"),
             ("bbox", "bbox"), ("joint", "joint"))


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train Faster-VoxelPose (PyTorch/CUDA port)")
    p.add_argument("--cfg", required=True, help="experiment yaml")
    p.add_argument("--epochs", type=int, default=None, help="override END_EPOCH")
    p.add_argument("--num-data", type=int, default=None, help="override SYNTHETIC.NUM_DATA")
    p.add_argument("--resume", action="store_true", help="resume from checkpoint")
    p.add_argument("--eval-every", type=int, default=1,
                   help="validate every N epochs (the final epoch always validates)")
    p.add_argument("--device", default=None, help="'cpu' runs the plain PyTorch path")
    p.add_argument("--eager", action="store_true",
                   help="issue every step's kernels from Python (no CUDA graph)")
    p.add_argument("--snapshot-dir", default=None,
                   help="where each new best's model_best.npz and eval_record.json go "
                        "(default: checkpoints/<cfg stem> of this repository)")
    return p.parse_args(argv)


def config_path_for_record(cfg_path: str) -> str:
    """The config's path relative to the repository where it lies inside
    it, else its absolute path."""
    path = pathlib.Path(cfg_path).resolve()
    try:
        return path.relative_to(REPO).as_posix()
    except ValueError:
        return str(path)


def train_vis(cfg: Config, trainer: Trainer, batch, resize_transform, prefix: str) -> list:
    """`utils/vis.train_vis_all` of a batch after its train step: an eval
    forward (train=False: BatchNorm reads its running statistics and
    updates nothing) of the current weights on the batch's heatmaps (its
    own, rendered from its 'hm_params', or the backbone's of its
    'images'), eagerly and outside the step's CUDA graph, whose static
    inputs it does not touch.  Returns the files written."""
    from ..utils.vis import train_vis_all

    with torch.no_grad():
        hm = trainer.heatmaps(batch)
        out = trainer.model(hm, batch["cameras"], train=False)
    images = None
    if "images" in batch:
        images = batch["images"].cpu().numpy()
        if images.dtype != np.uint8:
            images = denormalize_images(images)
    return train_vis_all(cfg, out.fused_poses.cpu().numpy(), out.proposal_centers.cpu().numpy(),
                         hm.cpu().numpy(), prefix, images=images,
                         packed_rigs=batch["cameras"].cpu().numpy(),
                         resize_transform=resize_transform if images is not None else None)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    cfg = load_config(args.cfg)
    if args.epochs is not None:
        cfg.TRAIN.END_EPOCH = args.epochs
    if args.num_data is not None:
        cfg.SYNTHETIC.NUM_DATA = args.num_data
    if args.resume:
        cfg.TRAIN.RESUME = True
    if cfg.TRAIN.UPDATE_BACKBONE_BN_STATS:
        raise NotImplementedError("TRAIN.UPDATE_BACKBONE_BN_STATS: the backbone is frozen, its "
                                  "BatchNorm statistics too; the JAX package declares this key "
                                  "but never reads it (its backbone always runs with "
                                  "train=False), and the port refuses it rather than ignore it")
    device = resolve_device(args.device)
    pin_float32()

    logger, output_dir, log_dir = create_logger(cfg, args.cfg, "train")
    writer = ScalarWriter(log_dir)
    logger.info("device: %s%s", device,
                f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")

    train_ds = get_dataset(cfg.DATASET.TRAIN_DATASET)(cfg, is_train=True)
    test_ds = get_dataset(cfg.DATASET.TEST_DATASET)(cfg, is_train=False)

    torch.manual_seed(cfg.TRAIN.SEED)
    model = build_model(cfg).to(device)
    backbone = None
    if "image" in (cfg.DATASET.TRAIN_HEATMAP_SRC, cfg.DATASET.TEST_HEATMAP_SRC):
        backbone = build_backbone(cfg)
        if cfg.NETWORK.PRETRAINED_BACKBONE:
            backbone.load_state_dict(convert_backbone(
                load_torch_state_dict(cfg.NETWORK.PRETRAINED_BACKBONE), cfg.RESNET.NUM_LAYERS,
                backbone))
            logger.info("=> loaded pretrained backbone %s", cfg.NETWORK.PRETRAINED_BACKBONE)
        backbone.to(device)

    trainer = Trainer(cfg, model, compiled=device.type == "cuda" and not args.eager,
                      backbone=backbone)
    loader = DataLoader(
        train_ds, cfg.TRAIN.BATCH_SIZE, shuffle=cfg.TRAIN.SHUFFLE, drop_last=True,
        num_workers=cfg.WORKERS, seed=cfg.TRAIN.SEED,
        dataset_factory=DatasetFactory(cfg.DATASET.TRAIN_DATASET, cfg, True)
        if cfg.WORKERS > 0 else None)
    start_epoch, best_metric = 0, -np.inf
    if cfg.TRAIN.RESUME:
        start_epoch, best_metric = load_checkpoint(output_dir, trainer, loader)

    meters = {k: AverageMeter() for k in ("total", "2d", "1d", "bbox", "joint", "time")}
    global_step = 0
    try:
        for epoch in range(start_epoch, cfg.TRAIN.END_EPOCH):
            logger.info("epoch %d", epoch)
            t_epoch = end = time.time()
            for i, batch in enumerate(prefetch_to_device(iter(loader), device=device)):
                wait_if_bench_locked()
                losses = trainer.step(batch)
                if i % cfg.PRINT_FREQ == 0:
                    # reading the losses waits for this step: the batch time is
                    # the step's, not the issue queue's
                    losses = {k: float(v) for k, v in losses.items()}
                    batch_time = (time.time() - end) / (1 if i == 0 else cfg.PRINT_FREQ)
                    meters["time"].update(batch_time)
                    for k, mk in LOSS_KEYS:
                        meters[mk].update(losses[k])
                        writer.add_scalar(f"train_loss_{mk}", losses[k], global_step)
                    logger.info(
                        "Epoch [%d][%d/%d] Speed %.1f samples/s (%.3fs/batch) "
                        "Loss %.6f (2d %.6f 1d %.6f bbox %.6f joint %.6f)",
                        epoch, i, len(loader), cfg.TRAIN.BATCH_SIZE / max(batch_time, 1e-9),
                        batch_time, losses["total"], losses["2d_heatmaps"],
                        losses["1d_heatmaps"], losses["bbox"], losses["joint"])
                    if cfg.TRAIN.VISUALIZATION:
                        train_vis(cfg, trainer, batch, train_ds.resize_transform,
                                  os.path.join(output_dir, "train_vis", f"{epoch}_{i:06d}"))
                    end = time.time()
                global_step += 1
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            logger.info("epoch %d trained in %.3f s", epoch, time.time() - t_epoch)

            is_best = False
            # eval_every <= 0 means "final epoch only" (and guards the % 0)
            if (args.eval_every > 0 and (epoch + 1) % args.eval_every == 0) \
                    or epoch + 1 == cfg.TRAIN.END_EPOCH:
                metric, msg, _ = run_validation(
                    cfg, model, test_ds, device=device,
                    dataset_factory=DatasetFactory(cfg.DATASET.TEST_DATASET, cfg, False)
                    if cfg.WORKERS > 0 else None,
                    compiled=trainer.compiled,
                    backbone=backbone if cfg.DATASET.TEST_HEATMAP_SRC == "image" else None)
                writer.add_scalar("eval_metric", metric, epoch)
                is_best = metric > best_metric
                best_metric = max(metric, best_metric)
                if is_best:
                    write_repo_snapshot(
                        output_dir, model,
                        {"config": config_path_for_record(args.cfg), "epoch": epoch + 1,
                         "metric": float(metric), "message": msg, "seed": cfg.TRAIN.SEED},
                        snapshot_dir=args.snapshot_dir)
            save_checkpoint(output_dir, trainer, epoch + 1, best_metric, is_best, loader)
    finally:
        loader.close()
        writer.close()
    logger.info("kernel launches: %s", json.dumps(sk.launch_counts()))
    logger.info("done; best metric %.4f", best_metric)
    return 0


if __name__ == "__main__":
    sys.exit(main())
