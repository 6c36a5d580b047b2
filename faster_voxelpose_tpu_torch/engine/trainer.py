"""Training engine of the port: the two-optimizer train step, eager or
captured into a CUDA graph (counterpart of
`faster_voxelpose_tpu/engine/trainer.py`, reference
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
* Both gates are device tensors, as the JAX step's `lax.cond` and
  MultiSteps' `jnp.where` are: the mini-step counter and the `joint > 0`
  flag.  `Adam` is optax's adam (b1 0.9, b2 0.999, eps 1e-8, no weight
  decay) written as tensor math on flat buffers and applied under such a
  mask, so a step reads nothing back to the host and one body runs
  eagerly (the CPU) and inside a CUDA graph (the card).
* Heatmaps come in the batch ('input_heatmaps'), are rendered on the
  device from 'hm_params' (ops/heatmap_render.py), or are made from
  'images' by the frozen backbone, as the JAX package's train step does.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..models.resnet import PoseResNet, images_to_heatmaps
from ..ops.heatmap_render import render_heatmaps_device
from .graphs import GraphedStep

TARGET_KEYS = ("2d_heatmaps", "1d_heatmaps", "index", "bbox", "mask")
META_KEYS = ("roots_3d", "bbox", "num_person", "joints_3d", "joints_3d_vis")
HEATMAP_KEYS = ("input_heatmaps", "hm_params", "images")
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


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


class Adam:
    """optax.adam(lr) over `params`, applied under a device mask.

    The gradient, both moments and the update live in flat buffers made
    once; each parameter's `.grad` is bound once to its view of the flat
    gradient, so a backward accumulates into it in place and nothing is
    rebound afterwards.  `step(grad, apply)` takes a flat gradient and a
    0-dim bool tensor: where `apply` is false the parameters, moments and
    step count stay bit for bit (the parameters get -0.0 added)."""

    def __init__(self, params: List[nn.Parameter], lr: float):
        self.params, self.lr = list(params), float(lr)
        if len({(p.dtype, p.device) for p in self.params}) != 1:
            raise ValueError("Adam's parameters must share one dtype and device")
        p0 = self.params[0]
        n = sum(p.numel() for p in self.params)
        self.grad = torch.zeros(n, dtype=p0.dtype, device=p0.device)
        self.mu = torch.zeros_like(self.grad)
        self.nu = torch.zeros_like(self.grad)
        self.count = torch.zeros((), dtype=torch.int32, device=p0.device)
        self._delta = torch.zeros_like(self.grad)
        self._delta_views = self.views(self._delta)
        self._grad_views = self.views(self.grad)
        for p, g in zip(self.params, self._grad_views):
            p.grad = g

    def views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """`flat` cut into tensors shaped as the parameters, in order."""
        out, o = [], 0
        for p in self.params:
            out.append(flat[o:o + p.numel()].view_as(p))
            o += p.numel()
        return out

    def check_grads_bound(self) -> None:
        """Raise if a parameter's `.grad` is no longer its view of the flat
        gradient (e.g. after `model.zero_grad(set_to_none=True)`)."""
        if any(p.grad is not g for p, g in zip(self.params, self._grad_views)):
            raise RuntimeError("a parameter's .grad was rebound; the trainer binds them once")

    @torch.no_grad()
    def step(self, grad: torch.Tensor, apply: torch.Tensor) -> None:
        count = self.count + 1
        mu = grad * (1 - B1) + self.mu * B1
        nu = grad * grad * (1 - B2) + self.nu * B2
        upd = (mu / (1 - B1 ** count)) / (torch.sqrt(nu / (1 - B2 ** count)) + EPS)
        self._delta.copy_(torch.where(apply, upd * -self.lr, -0.0))
        torch._foreach_add_(self.params, self._delta_views)
        self.mu.copy_(torch.where(apply, mu, self.mu))
        self.nu.copy_(torch.where(apply, nu, self.nu))
        self.count.copy_(torch.where(apply, count, self.count))

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {"mu": self.mu, "nu": self.nu, "count": self.count}

    def load_state_dict(self, state: Mapping[str, torch.Tensor]) -> None:
        for k, v in self.state_dict().items():
            v.copy_(state[k])


def batch_to_device(batch: Mapping[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A collated batch (numpy) as tensors on `device`; keys starting
    with '_' stay on the host."""
    return {k: (v if k.startswith("_") else torch.as_tensor(np.asarray(v)).to(device))
            for k, v in batch.items()}


class Trainer:
    """Train steps of a FasterVoxelPoseNet on the model's device.

    `step(batch)` takes a batch (numpy arrays or tensors) with 'cameras',
    the targets and meta of `datasets.base`, and one heatmap source:
    'input_heatmaps' (B, V, H, W, J), 'hm_params' (B, V, K, J, 12) or
    'images' (B, V, ih, iw, 3), the last with `backbone`; other keys are
    ignored.  It returns the detached losses.

    `compiled` (default: true on a CUDA device) captures the step into a
    CUDA graph (`graphs.GraphedStep`): the first CAPTURE_WARMUP steps run
    eagerly on a side stream, real steps on the batches given, then one
    capture, and every later step copies its batch into the graph's static
    inputs and replays.  The losses are then the graph's static tensors,
    overwritten by the next step: read them before it.  Every batch must
    have the shapes of the first captured one.  A failed capture raises;
    a compiled trainer never steps eagerly in place of its graph."""

    def __init__(self, cfg: Config, model: nn.Module, compiled: Optional[bool] = None,
                 backbone: Optional[PoseResNet] = None):
        self.cfg, self.model, self.backbone = cfg, model, backbone
        self.device = next(model.parameters()).device
        if compiled is None:
            compiled = self.device.type == "cuda"
        pose, joint = partition_params(model)
        self.opt_pose = Adam(pose, cfg.TRAIN.LR)
        self.opt_joint = Adam(joint, cfg.TRAIN.LR)
        self.every_k = int(cfg.TRAIN.ACCUMULATION_STEPS)
        # MultiSteps' running mean of the HDN gradients and its mini-step
        self.acc = torch.zeros_like(self.opt_pose.grad)
        self.mini_step = torch.zeros((), dtype=torch.int32, device=self.device)
        self._graph = GraphedStep(self.device) if compiled else None

    @property
    def compiled(self) -> bool:
        return self._graph is not None

    def heatmaps(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        if "input_heatmaps" in batch:
            return batch["input_heatmaps"]
        if "hm_params" in batch:
            W, H = self.cfg.DATASET.HEATMAP_SIZE
            return render_heatmaps_device(batch["hm_params"], H, W)
        if "images" in batch:
            if self.backbone is None:
                raise ValueError("a batch of 'images' needs the trainer's backbone")
            with torch.no_grad():
                return images_to_heatmaps(self.backbone, batch["images"],
                                          self.cfg.DATASET.COLOR_RGB)
        raise KeyError(f"batch holds none of {HEATMAP_KEYS}")

    def loss(self, batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Forward in train mode: the losses, with the graph attached."""
        targets = {k: batch[k] for k in TARGET_KEYS}
        meta = {k: batch[k] for k in META_KEYS}
        out = self.model(self.heatmaps(batch), batch["cameras"], targets=targets,
                         meta=meta, train=True)
        return out.losses

    def step_body(self, batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One train step on a batch of tensors on the device, free of
        host synchronisation and of tensor rebinding: what the graph
        captures, and what an eager step runs."""
        self.opt_pose.grad.zero_()
        self.opt_joint.grad.zero_()
        losses = self.loss(batch)
        losses["total"].backward()
        losses = self.reduce({k: v.detach() for k, v in losses.items()})
        with torch.no_grad():
            n = self.mini_step
            emit = n == self.every_k - 1
            acc = self.acc + (self.opt_pose.grad - self.acc) / (n + 1)
            self.opt_pose.step(acc, emit)
            self.acc.copy_(torch.where(emit, 0.0, acc))
            self.mini_step.copy_(torch.where(emit, 0, n + 1))
            self.opt_joint.step(self.opt_joint.grad, losses["joint"] > 0)
        return losses

    def reduce(self, losses: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The step's losses and gradients (`opt_pose.grad`,
        `opt_joint.grad`) after the backward, made those of the whole
        batch: on one process they already are.  A data-parallel trainer
        sums them over the ranks (`parallel.mesh`)."""
        return losses

    def _inputs(self, batch: Mapping[str, object]) -> Dict[str, torch.Tensor]:
        src = next((k for k in HEATMAP_KEYS if k in batch), None)
        if src is None:
            raise KeyError(f"batch holds none of {HEATMAP_KEYS}")
        keys = dict.fromkeys((src, "cameras") + TARGET_KEYS + META_KEYS)
        return {k: torch.as_tensor(batch[k]) for k in keys}

    def step(self, batch: Mapping[str, object]) -> Dict[str, torch.Tensor]:
        self.opt_pose.check_grads_bound()
        self.opt_joint.check_grads_bound()
        inputs = {k: v.to(self.device, non_blocking=True) for k, v in self._inputs(batch).items()}
        if self._graph is not None:
            return self._graph(self.step_body, inputs)
        return self.step_body(inputs)

    # -- checkpointing ----------------------------------------------------

    def state_dict(self) -> Dict[str, object]:
        """The model's parameters and BatchNorm statistics, both Adams'
        moments and step counts, the HDN accumulator and mini-step."""
        return {"model": self.model.state_dict(), "pose": self.opt_pose.state_dict(),
                "joint": self.opt_joint.state_dict(), "acc": self.acc,
                "mini_step": self.mini_step}

    def load_state_dict(self, state: Mapping[str, object]) -> None:
        """Copy a `state_dict` into the trainer's tensors in place, so a
        captured graph goes on reading them."""
        self.model.load_state_dict(state["model"])
        self.opt_pose.load_state_dict(state["pose"])
        self.opt_joint.load_state_dict(state["joint"])
        self.acc.copy_(state["acc"])
        self.mini_step.copy_(state["mini_step"])


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
