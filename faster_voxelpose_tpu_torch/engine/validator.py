"""Evaluation engine of the port (counterpart of
`faster_voxelpose_tpu/engine/validator.py`, reference
lib/core/function.py:117-174): batched inference over an evaluation set,
sequential and unshuffled, then the dataset's own metric protocol.

Heatmaps come in the batch ('input_heatmaps') or are rendered on the
device from 'hm_params', as in training.  The last batch is short, not
padded: PyTorch needs no static shapes, so no padding rows are discarded.
Samples are made in the calling process, in record order, so that the
dataset's augmentation draws follow its one RandomState; nothing may call
`dataset[i]` before the loop starts, or every later draw shifts.
`make_eval_step` with a backbone gives the image step; `run_validation`
has no image loader yet (the JAX package's decodes files with cv2).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..device import DeviceLike, pin_float32, resolve_device
from ..models.resnet import PoseResNet, images_to_heatmaps
from ..ops.heatmap_render import render_heatmaps_device
from .loader import make_loader
from .trainer import batch_to_device

logger = logging.getLogger(__name__)


def make_eval_step(cfg: Config, model: nn.Module,
                   backbone: Optional[PoseResNet] = None) -> Callable:
    """One eval step under inference mode.  Without `backbone`: a batch of
    tensors on the model's device -> fused poses (B, K, J, 5).  With it,
    the image step: (images (B, V, ih, iw, 3), cameras (B, V, 21)) ->
    fused poses, uint8 frames normalised on the device, then the backbone
    over the B * V frames, then the model (the JAX package's
    `eval_step_images`)."""
    W, H = cfg.DATASET.HEATMAP_SIZE

    def eval_step(batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        with torch.inference_mode():
            heatmaps = batch.get("input_heatmaps")
            if heatmaps is None:
                heatmaps = render_heatmaps_device(batch["hm_params"], H, W)
            return model(heatmaps, batch["cameras"], train=False).fused_poses

    if backbone is None:
        return eval_step

    def eval_step_images(images: torch.Tensor, cameras: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            heatmaps = images_to_heatmaps(backbone, images, cfg.DATASET.COLOR_RGB)
            return model(heatmaps, cameras, train=False).fused_poses

    return eval_step_images


def run_validation(cfg: Config, model: nn.Module, dataset, batch_size: Optional[int] = None,
                   device: DeviceLike = None) -> Tuple[float, str, np.ndarray]:
    """Evaluate `model` on every record of `dataset`; returns (metric,
    message, preds (N, K, J, 5)).  Runs on the CUDA device and raises if
    there is none, unless `device` names another; the model is moved
    there."""
    device = resolve_device(device)
    pin_float32()
    model = model.to(device).eval()
    eval_step = make_eval_step(cfg, model)
    loader = make_loader(dataset, batch_size or cfg.TEST.BATCH_SIZE, shuffle=False,
                         drop_last=False)
    all_preds = []
    t0 = time.perf_counter()
    for batch in loader:
        keys = ("cameras", "input_heatmaps" if "input_heatmaps" in batch else "hm_params")
        all_preds.append(eval_step(batch_to_device({k: batch[k] for k in keys}, device))
                         .cpu().numpy())
    preds = np.concatenate(all_preds, axis=0)
    dt = time.perf_counter() - t0
    n = len(dataset)
    logger.info("validated %d frames in %.1fs (%.1f frames/s) on %s", n, dt, n / max(dt, 1e-9),
                device)
    metric, msg = dataset.evaluate(preds)
    logger.info("\n%s", msg)
    return metric, msg, preds
