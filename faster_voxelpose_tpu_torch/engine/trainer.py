"""Training engine of the port: the two-optimizer train step (counterpart
of `faster_voxelpose_tpu/engine/trainer.py`, reference
lib/core/function.py:15-114 and run/train.py:39-54).

* One backward of the total loss (2d + 1d + bbox + joint) feeds both
  optimizers: the HDN and JLN parameter sets are disjoint and the JLN sees
  only detached proposals, so the per-partition gradients are those of
  the reference's two backward passes.
* HDN ('pose'): Adam with optax.MultiSteps semantics: the gradients of
  ACCUMULATION_STEPS calls are averaged (a running mean, as optax takes
  it), Adam steps on the k-th call, and its step count advances only then.
* JLN ('joint'): Adam, skipped with its state untouched when the joint
  loss is exactly 0 (no valid proposal; reference function.py:65).
* Both Adams take optax's defaults: b1 0.9, b2 0.999, eps 1e-8, no
  weight decay.
* Heatmaps come in the batch ('input_heatmaps') or are rendered on the
  device from 'hm_params' (ops/heatmap_render.py), as the JAX package's
  train step does.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..ops.heatmap_render import render_heatmaps_device

TARGET_KEYS = ("2d_heatmaps", "1d_heatmaps", "index", "bbox", "mask")
META_KEYS = ("roots_3d", "bbox", "num_person", "joints_3d", "joints_3d_vis")


def partition_params(model: nn.Module) -> Tuple[List[nn.Parameter], List[nn.Parameter]]:
    """Split the model's parameters into (pose = hdn, joint = jln).

    The partition must cover every parameter: a top-level submodule that
    is neither 'hdn' nor 'jln' would silently get no updates, so it is an
    error (JAX package engine/trainer.py:44-60)."""
    pose, joint, uncovered = [], [], set()
    for name, p in model.named_parameters():
        head = name.split(".", 1)[0]
        if head == "hdn":
            pose.append(p)
        elif head == "jln":
            joint.append(p)
        else:
            uncovered.add(head)
    if uncovered:
        raise ValueError(
            f"parameter subtrees {sorted(uncovered)} are covered by neither "
            "optimizer partition (pose='hdn', joint='jln'); they would get "
            "zero updates"
        )
    return pose, joint


def _adam(params, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)


class MultiStepAdam:
    """Adam stepped every k calls on the running mean of the k gradients
    (optax.MultiSteps(adam, every_k_schedule=k), use_grad_mean=True)."""

    def __init__(self, params: List[nn.Parameter], lr: float, every_k: int):
        self.params = params
        self.every_k = int(every_k)
        self.inner = _adam(params, lr)
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self) -> None:
        """Fold the current .grad into the mean; on the k-th call, step
        Adam on the mean and reset it."""
        n = self.mini_step
        for p, a in zip(self.params, self.acc):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            a.add_((g - a) / (n + 1))
        self.mini_step = (n + 1) % self.every_k
        if self.mini_step != 0:
            return
        for p, a in zip(self.params, self.acc):
            p.grad = a.clone()
            a.zero_()
        self.inner.step()


def batch_to_device(batch: Mapping[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A collated batch (numpy) as tensors on `device`; keys starting
    with '_' stay on the host."""
    return {k: (v if k.startswith("_") else torch.as_tensor(np.asarray(v)).to(device))
            for k, v in batch.items()}


class Trainer:
    """Train steps of a FasterVoxelPoseNet on one device.

    `step(batch)` takes a batch of tensors (see `batch_to_device`) with
    'cameras', the targets and meta of `datasets.base`, and
    'input_heatmaps' (B, V, H, W, J) or 'hm_params' (B, V, K, J, 12);
    it returns the detached losses."""

    def __init__(self, cfg: Config, model: nn.Module):
        self.cfg, self.model = cfg, model
        pose, joint = partition_params(model)
        self.opt_pose = MultiStepAdam(pose, cfg.TRAIN.LR, cfg.TRAIN.ACCUMULATION_STEPS)
        self.opt_joint = _adam(joint, cfg.TRAIN.LR)

    def heatmaps(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        if "input_heatmaps" in batch:
            return batch["input_heatmaps"]
        if "hm_params" in batch:
            W, H = self.cfg.DATASET.HEATMAP_SIZE
            return render_heatmaps_device(batch["hm_params"], H, W)
        raise KeyError("batch holds neither 'input_heatmaps' nor 'hm_params' "
                       "(the image path is not ported)")

    def loss(self, batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Forward in train mode: the losses, with the graph attached."""
        targets = {k: batch[k] for k in TARGET_KEYS}
        meta = {k: batch[k] for k in META_KEYS}
        out = self.model(self.heatmaps(batch), batch["cameras"], targets=targets,
                         meta=meta, train=True)
        return out.losses

    def step(self, batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        self.model.zero_grad(set_to_none=True)
        losses = self.loss(batch)
        losses["total"].backward()
        self.opt_pose.step()
        if float(losses["joint"].detach()) > 0:
            self.opt_joint.step()
        return {k: v.detach() for k, v in losses.items()}


class AverageMeter:
    """Running mean tracker (reference function.py:177-192)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0
