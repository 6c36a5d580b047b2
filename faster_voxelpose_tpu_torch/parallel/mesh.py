"""Scale-out of the port on torch.distributed (counterpart of
`faster_voxelpose_tpu/parallel/mesh.py`).

A mesh is the process group of an initialised torch.distributed run plus
this rank's device: the card unless the caller names the CPU (NCCL on
the card, gloo on the CPU or the card).  Initialising the group is the caller's
job (`torch.distributed.init_process_group` with its address, world size
and rank), as `jax.distributed` is in JAX.  Every function holds to the
JAX function's contract: the same answers as one device on the whole
batch.  What XLA inserts for a batch-sharded jit is written out here:

* `data` axis, training (`make_dp_train_step`): each rank runs its
  contiguous shard of the global batch (`shard_batch`).  Every loss is a
  global mean (each rank's numerator over the all-reduced count,
  `FasterVoxelPoseNet.set_global_sum`), every BatchNorm takes the global
  batch's statistics (its sum, sum of squares and count all-reduced, with
  autograd through the sum), the two flat gradient buffers are summed
  over the ranks (two all-reduces), and the losses that the step returns
  and its joint gate reads are the global ones.  The parameters after a
  step are then those of one process's step on the global batch.
* `data` axis, evaluation (`make_dp_eval_step`): each rank evaluates its
  shard; the fused poses are all-gathered into the global batch order.
* view axis (`make_view_sharded_forward`): see its docstring.
* `PipelinedStream`: backbone and fusion as two pipeline stages.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..config import Config
from ..engine.trainer import Trainer
from ..models.resnet import PoseResNet, images_to_heatmaps


class Mesh(NamedTuple):
    """A process group, this rank's device and the name of the group's
    one axis."""

    group: Any
    device: torch.device
    axis_name: str = "data"

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)


class Sharding(NamedTuple):
    """Where a tensor lies on a mesh: its `axis` split into one contiguous
    slice per rank, or (`axis` None) all of it on every rank."""

    mesh: Mesh
    axis: Optional[int]

    def shard(self, x) -> torch.Tensor:
        """This rank's part of the global `x`, on the mesh's device."""
        x = torch.as_tensor(x)
        if self.axis is not None:
            n, size = x.shape[self.axis], self.mesh.size
            if n % size:
                raise ValueError(f"axis {self.axis} of length {n} does not split over "
                                 f"{size} ranks")
            x = x.narrow(self.axis, self.mesh.rank * (n // size), n // size)
        return x.to(self.mesh.device)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
              device=None, group=None) -> Mesh:
    """The mesh of the initialised process group `group` (default: the
    world).  Raises where no process group is initialised, and where
    `n_devices` is not the group's size.  `device`, where not given, is
    the card `rank % device_count` under every backend (gloo carries
    CUDA tensors too), and raises where there is no card: a CPU mesh is
    asked for with `device='cpu'`."""
    if not dist.is_initialized():
        raise RuntimeError("no torch.distributed process group is initialised: call "
                           "torch.distributed.init_process_group first")
    group = group if group is not None else dist.group.WORLD
    size = dist.get_world_size(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} devices over a process group of {size}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' for a mesh on "
                               "the CPU")
        device = f"cuda:{dist.get_rank(group) % torch.cuda.device_count()}"
    return Mesh(group, torch.device(device), axis_name)


def batch_sharding(mesh: Mesh, axis_name: str = "data") -> Sharding:
    if axis_name != mesh.axis_name:
        raise ValueError(f"the mesh's axis is {mesh.axis_name!r}, not {axis_name!r}")
    return Sharding(mesh, 0)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def shard_batch(batch: Mapping[str, Any], mesh: Mesh,
                axis_name: str = "data") -> Dict[str, torch.Tensor]:
    """Every batch array's contiguous slice of its leading (batch) axis
    for this rank, on the mesh's device."""
    sh = batch_sharding(mesh, axis_name)
    return {k: sh.shard(v) for k, v in batch.items()}


def all_gather(x: torch.Tensor, mesh: Mesh, axis: int) -> torch.Tensor:
    """The ranks' `x` concatenated along `axis` in rank order (one
    all-gather; every rank's `x` has one shape)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts, dim=axis)


class _GlobalSum(torch.autograd.Function):
    """x summed over the ranks; the gradient of each rank's input is the
    sum of the ranks' output gradients."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return None, grad


class DataParallelTrainer(Trainer):
    """A `Trainer` whose `step` takes this rank's shard of the global batch
    (`shard_batch`) and is a data-parallel step (the module docstring).
    The parameters and buffers are broadcast from rank 0 at construction,
    so that every rank starts from one state.

    `compiled` (default: true on a CUDA device under NCCL) captures the
    step, collectives included, into the trainer's CUDA graph.  gloo's
    collectives cannot be captured: `compiled=True` there raises, and the
    step runs eagerly only when the caller passes `compiled=False`."""

    def __init__(self, cfg: Config, model: nn.Module, mesh: Mesh,
                 compiled: Optional[bool] = None, backbone: Optional[PoseResNet] = None):
        graphable = mesh.device.type == "cuda" and mesh.backend == "nccl"
        if compiled is None:
            compiled = graphable
        if compiled and not graphable:
            raise ValueError(f"a {mesh.backend} step on {mesh.device} cannot be captured into a "
                             "CUDA graph: pass compiled=False")
        model.to(mesh.device)
        if backbone is not None:
            backbone.to(mesh.device)
        with torch.no_grad():
            for t in [*model.parameters(), *model.buffers()]:
                dist.broadcast(t.data, 0, group=mesh.group)
        super().__init__(cfg, model, compiled=compiled, backbone=backbone)
        self.mesh = mesh

    def _global_sum(self, x: torch.Tensor) -> torch.Tensor:
        return _GlobalSum.apply(self.mesh.group, x)

    def loss(self, batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's share of the global losses: their sum over the ranks
        is the global batch's loss."""
        self.model.set_global_sum(self._global_sum)
        try:
            return super().loss(batch)
        finally:
            self.model.set_global_sum(None)

    def reduce(self, losses: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The two flat gradient buffers and the losses summed over the
        ranks: three all-reduces."""
        group = self.mesh.group
        dist.all_reduce(self.opt_pose.grad, group=group)
        dist.all_reduce(self.opt_joint.grad, group=group)
        keys = list(losses)
        stacked = torch.stack([losses[k] for k in keys])
        dist.all_reduce(stacked, group=group)
        return dict(zip(keys, stacked.unbind()))


def make_dp_train_step(cfg: Config, model: nn.Module, mesh: Mesh,
                       backbone: Optional[PoseResNet] = None,
                       compiled: Optional[bool] = None) -> DataParallelTrainer:
    """The data-parallel trainer: `make_dp_train_step(...).step(shard)`
    returns the global losses of the global batch that the ranks' shards
    make up."""
    return DataParallelTrainer(cfg, model, mesh, compiled=compiled, backbone=backbone)


def make_dp_eval_step(cfg: Config, model: nn.Module, mesh: Mesh):
    """eval_step(heatmaps, cameras) of this rank's shards (B/n, V, ...) ->
    the global batch's fused poses (B, K, J, 5) on every rank, in batch
    order."""
    model = model.to(mesh.device).eval()

    def eval_step(heatmaps: torch.Tensor, cameras: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            fused = model(heatmaps.to(mesh.device), cameras.to(mesh.device)).fused_poses
        return all_gather(fused, mesh, 0)

    return eval_step


def make_view_sharded_forward(cfg: Config, model: nn.Module, mesh: Mesh,
                              axis: str = "data"):
    """forward(heatmaps, cameras) of this rank's views (B, V/n, ...) -> the
    fused poses (B, K, J, 5) of all V views, the same on every rank.

    The view shards are all-gathered to all V views, then the one-device
    forward runs with its kernels (rows 1 and 2 of the kernel table).
    That is what the JAX package's TPU path does: it has no shard_map or
    custom_partitioning, and its Pallas call no partitioning rule, so XLA
    gathers the kernel's operands to every device.  A partial-sum design
    would have each rank sum its own views inside the whole-space kernel
    and all-reduce the sums before the mean's clamp; it is not done here.
    Requires V % mesh size == 0."""
    if axis != mesh.axis_name:
        raise ValueError(f"the mesh's axis is {mesh.axis_name!r}, not {axis!r}")
    model = model.to(mesh.device).eval()

    def forward(heatmaps: torch.Tensor, cameras: torch.Tensor) -> torch.Tensor:
        hm = all_gather(heatmaps.to(mesh.device), mesh, 1)
        cams = all_gather(cameras.to(mesh.device), mesh, 1)
        with torch.no_grad():
            return model(hm, cams).fused_poses

    return forward


class PipelinedStream:
    """Backbone -> fusion as a two-stage pipeline for streaming inference,
    with a one-frame lag: `push(frame t)` returns frame t-1's
    (fused_poses (K, J, 5), proposal_centers (K, 7)), or None on the
    first push; `flush()` drains the last frame in flight and returns
    None when there is none.

    Stage 0 runs the backbone on `devices[0]`, stage 1 the fusion on
    `devices[1]` (default: the first two cards, or the one card twice).
    On a card each stage runs on a CUDA stream of its own, joined by an
    event recorded after frame t's heatmaps: frame t's backbone is issued
    before frame t-1's fusion, so that on two cards both run at once and
    on one card the two streams overlap.  On the CPU the stages run in
    turn.  Frames are (V, ih, iw, 3) at IMAGE_SIZE: uint8 (BGR, normalised
    on the device) or float32 (normalised already); `cams` is the packed
    (V, 21) rig."""

    def __init__(self, cfg: Config, model: nn.Module, backbone: PoseResNet, cams,
                 devices: Optional[Sequence] = None):
        if devices is None:
            n = torch.cuda.device_count()
            if n == 0:
                raise RuntimeError("no CUDA device; pass devices=('cpu', 'cpu') to run the "
                                   "stages on the CPU")
            devices = ("cuda:0", "cuda:1" if n > 1 else "cuda:0")
        devs = [torch.device(d) for d in devices]
        self.d0, self.d1 = devs[0], devs[-1]
        self.color_rgb = cfg.DATASET.COLOR_RGB
        self.backbone = backbone.to(self.d0).eval()
        self.model = model.to(self.d1).eval()
        cams = torch.as_tensor(np.asarray(cams, np.float32))
        self.cams = (cams[None] if cams.ndim == 2 else cams).to(self.d1)
        self._streams = None
        if self.d0.type == "cuda":
            self._streams = (torch.cuda.Stream(self.d0), torch.cuda.Stream(self.d1))
            for d in {self.d0, self.d1}:
                torch.cuda.synchronize(d)  # the weights and rig, copied on the default streams
        # frame t-1's heatmaps on d1 and the event after which they are ready
        self._pending: Optional[Tuple[torch.Tensor, Optional[torch.cuda.Event]]] = None

    def _backbone_stage(self, images: torch.Tensor):
        if self._streams is None:
            with torch.no_grad():
                hm = images_to_heatmaps(self.backbone, images[None].to(self.d0), self.color_rgb)
            return hm[0].to(self.d1), None
        s0 = self._streams[0]
        with torch.cuda.stream(s0), torch.no_grad():
            hm = images_to_heatmaps(self.backbone, images[None].to(self.d0), self.color_rgb)
            hm = hm[0].to(self.d1)
            ready = torch.cuda.Event()
            ready.record(s0)
        return hm, ready

    def _fuse(self) -> Tuple[np.ndarray, np.ndarray]:
        hm, ready = self._pending
        self._pending = None
        if self._streams is None:
            with torch.no_grad():
                out = self.model(hm[None], self.cams)
            return out.fused_poses[0].numpy(), out.proposal_centers[0].numpy()
        s1 = self._streams[1]
        with torch.cuda.stream(s1), torch.no_grad():
            s1.wait_event(ready)
            hm.record_stream(s1)
            out = self.model(hm[None], self.cams)
            return out.fused_poses[0].cpu().numpy(), out.proposal_centers[0].cpu().numpy()

    def push(self, images) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Feed frame t's (V, ih, iw, 3) images; returns frame t-1's
        (fused_poses, proposal_centers), or None on the first frame."""
        x = torch.as_tensor(np.asarray(images))
        if x.dtype != torch.uint8:
            x = x.to(torch.float32)
        pending = self._backbone_stage(x)  # issued before t-1's fusion
        out = self._fuse() if self._pending is not None else None
        self._pending = pending
        return out

    def flush(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Drain the final in-flight frame."""
        return self._fuse() if self._pending is not None else None
