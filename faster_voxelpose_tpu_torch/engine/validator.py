"""Evaluation engine of the port (counterpart of
`faster_voxelpose_tpu/engine/validator.py`, reference
lib/core/function.py:117-174): batched inference over an evaluation set,
sequential and unshuffled, then the dataset's own metric protocol.

Heatmaps come in the batch ('input_heatmaps') or are rendered on the
device from 'hm_params', as in training.  Every batch has the static
batch size: the loader pads the final one by repeating its last sample,
and the padding rows are dropped, as the JAX validator does.  On the card
the eval step is a CUDA graph, captured once per `run_validation` call at
that batch size (`graphs.GraphedStep`).  Samples are made by the
loader's prefetch thread, in record order, so that the dataset's
augmentation draws follow its one RandomState; nothing may call
`dataset[i]` before the loop starts, or every later draw shifts.
`make_eval_step` with a backbone gives the image step, which
`run_validation` graphs in the same way, fed the batch's uint8 'images'
or the frames of an `image_loader`.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..device import DeviceLike, pin_float32, resolve_device
from ..models.resnet import PoseResNet, images_to_heatmaps
from ..ops.heatmap_render import render_heatmaps_device
from ..utils.bench_lock import wait_if_bench_locked
from ..utils.profiling import StepTimer
from .graphs import GraphedStep
from .loader import DataLoader, prefetch_to_device

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
                   device: DeviceLike = None, dataset_factory=None,
                   num_workers: Optional[int] = None,
                   compiled: Optional[bool] = None, backbone: Optional[PoseResNet] = None,
                   image_loader: Optional[Callable[[List[int]], np.ndarray]] = None,
                   ) -> Tuple[float, str, np.ndarray]:
    """Evaluate `model` on every record of `dataset`; returns (metric,
    message, preds (N, K, J, 5)).  Runs on the CUDA device and raises if
    there is none, unless `device` names another; the model (and the
    backbone) are moved there.  `compiled` (default: true on a CUDA
    device) replays the eval step from a CUDA graph.  With
    `dataset_factory`, samples are made by cfg.WORKERS (or
    `num_workers`) spawn processes; without it, by the prefetch thread.

    Heatmaps are the batch's 'input_heatmaps' (host rendering), or are
    rendered on the device from its 'hm_params'.  With `backbone`, the
    step is the image step: the frames are the batch's 'images' (the
    'image' source), or `image_loader(record indices)` -> (B, V, ih, iw,
    3) uint8 where it is given (the JAX package's argument; the padded
    tail repeats the last index)."""
    device = resolve_device(device)
    pin_float32()
    model = model.to(device).eval()
    if backbone is not None:
        backbone = backbone.to(device).eval()
    bs = batch_size or cfg.TEST.BATCH_SIZE
    n = len(dataset)
    eval_step = make_eval_step(cfg, model, backbone)
    if backbone is not None:
        images_step = eval_step
        eval_step = lambda batch: images_step(batch["images"], batch["cameras"])  # noqa: E731
    if compiled is None:
        compiled = device.type == "cuda"
    if compiled:
        graphed = GraphedStep(device, inference=True)
        step = lambda batch: graphed(eval_step, batch)  # noqa: E731
    else:
        step = eval_step
    workers = (cfg.WORKERS if num_workers is None else num_workers) \
        if dataset_factory is not None else 0
    loader = DataLoader(dataset, bs, shuffle=False, drop_last=False, num_workers=workers,
                        dataset_factory=dataset_factory)
    all_preds = []
    timer = StepTimer()
    t0 = time.perf_counter()
    try:
        for bi, batch in enumerate(prefetch_to_device(iter(loader), device=device)):
            wait_if_bench_locked()
            inputs = {"cameras": batch["cameras"]}
            if backbone is not None:
                if image_loader is not None:
                    idxs = list(range(bi * bs, min((bi + 1) * bs, n)))
                    idxs += [idxs[-1]] * (bs - len(idxs))
                    inputs["images"] = torch.as_tensor(image_loader(idxs)).to(device)
                elif "images" in batch:
                    inputs["images"] = batch["images"]
                else:
                    raise ValueError("the image step needs the batch's 'images' (the 'image' "
                                     "source) or an image_loader")
            elif "images" in batch:
                raise ValueError("a batch of 'images' needs the backbone")
            else:
                key = "input_heatmaps" if "input_heatmaps" in batch else "hm_params"
                inputs[key] = batch[key]
            with timer.step() as st:
                st.set(step(inputs))
            all_preds.append(st.result.cpu().numpy()[batch["_valid"]])
    finally:
        loader.close()
    preds = np.concatenate(all_preds, axis=0)
    dt = time.perf_counter() - t0
    logger.info("validated %d frames in %.1fs (%.1f frames/s) on %s%s; %s", n, dt,
                n / max(dt, 1e-9), device, " (CUDA graph)" if compiled else "",
                timer.summary())
    metric, msg = dataset.evaluate(preds)
    logger.info("\n%s", msg)
    return metric, msg, preds
