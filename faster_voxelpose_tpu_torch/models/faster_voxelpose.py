"""Top-level FasterVoxelPose model (counterpart of
`faster_voxelpose_tpu/models/faster_voxelpose.py`, reference
faster_voxelpose.py:18-105): HDN then JLN on heatmaps and a packed rig,
with the same `ModelOutputs` layout, and in train mode the four-term
training loss.  For serving, `FoldedModule.fold()` (label "fusion", as
every served module's: `blocks.fold_layers`) prepares the weights of
CenterNet, C2CNet, P2PNet and WeightNet once: BatchNorms folded into
their convolutions, every weight in the compute dtype; outside train
mode the folded layers then run on them.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..config import Config
from ..utils import profiling
from .blocks import BatchNorm, FoldedModule
from .common import DTYPES, ModelOutputs
from .hdn import HDNOutputs, HumanDetectionNet
from .jln import JLNOutputs, JointLocalizationNet
from .projection import make_projection_geometry, resolve_crop_route

GlobalSum = Callable[[torch.Tensor], torch.Tensor]


def masked_mean(values: torch.Tensor, mask: torch.Tensor,
                global_sum: Optional[GlobalSum] = None) -> torch.Tensor:
    """Mean of values where mask (broadcastable) is true; 0 when the mask
    is empty (reference early return when no proposal is valid,
    faster_voxelpose.py:70-78).  With `global_sum` (a data-parallel step)
    the count is the global batch's: the ranks' results then sum to the
    global batch's mean."""
    mask = torch.broadcast_to(mask, values.shape).to(values.dtype)
    total = torch.sum(values * mask)
    count = torch.sum(mask)
    if global_sum is not None:
        count = global_sum(count)
    return torch.where(count > 0, total / torch.clamp(count, min=1.0), torch.zeros_like(total))


def full_mean(values: torch.Tensor, global_sum: Optional[GlobalSum] = None) -> torch.Tensor:
    """The mean of every element: the sum over the element count, with
    `global_sum` the global batch's count."""
    count = values.new_full((), float(values.numel()))
    if global_sum is not None:
        count = global_sum(count)
    return torch.sum(values) / count


class FasterVoxelPoseNet(FoldedModule):
    FOLD_LABEL = "fusion"
    # set only inside a data-parallel train step (`set_global_sum`)
    global_sum: Optional[GlobalSum] = None

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.geom = make_projection_geometry(cfg)
        dtype = DTYPES[cfg.NETWORK.COMPUTE_DTYPE]
        J, K = cfg.DATASET.NUM_JOINTS, cfg.CAPTURE_SPEC.MAX_PEOPLE
        width = cfg.NETWORK.WIDTH_MULT
        self.hdn = HumanDetectionNet(
            self.geom, J, K, cfg.CAPTURE_SPEC.MIN_SCORE, dtype=dtype, width=width
        )
        self.jln = JointLocalizationNet(
            self.geom, K, cfg.NETWORK.BETA, J,
            cfg.NETWORK.NUM_CHANNEL_JOINT_FEAT,
            cfg.NETWORK.NUM_CHANNEL_JOINT_HIDDEN,
            dtype=dtype, width=width, crop_route=resolve_crop_route(cfg),
        )

    def set_global_sum(self, fn: Optional[GlobalSum]) -> None:
        """Make the train-mode losses and every BatchNorm's statistics
        those of the global batch of a data-parallel step: `fn` sums a
        tensor over the ranks, with autograd through the sum
        (`parallel.mesh`); None puts the model back to one process."""
        self.global_sum = fn
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.global_sum = fn

    def forward(self, heatmaps: torch.Tensor, cams: torch.Tensor,
                targets: Optional[Dict[str, torch.Tensor]] = None,
                meta: Optional[Dict[str, torch.Tensor]] = None,
                train: bool = False) -> ModelOutputs:
        """heatmaps (B, V, H, W, J) float32, cams (B, V, 21) float32.

        In train mode, meta ('roots_3d', 'bbox', 'num_person', 'joints_3d',
        'joints_3d_vis') matches the proposals to the ground truth and,
        with targets ('2d_heatmaps', '1d_heatmaps', 'index', 'bbox',
        'mask'), the losses are returned in `losses`."""
        J = self.cfg.DATASET.NUM_JOINTS
        if not train:
            self.serving(heatmaps)  # refolds first where a tensor moved
        heatmaps, cams = heatmaps.float(), cams.float()
        gt = meta if (train and meta) else {}
        hdn = self.hdn(heatmaps, cams, train, gt.get("roots_3d"), gt.get("bbox"),
                       gt.get("num_person"))
        profiling.mark("hdn")  # a no-op except in a service's graph capture
        mask = hdn.proposal_centers[:, :, 3] >= 0
        jln = self.jln(heatmaps, cams, hdn.proposal_centers, train)

        # eval-time confidence refresh (reference
        # joint_localization_net.py:98)
        pc = hdn.proposal_centers.clone()
        pc[:, :, 4] = torch.where(mask, jln.confidences, pc[:, :, 4])
        losses = None
        if train and targets is not None:
            losses = self._losses(hdn, jln, mask, targets, meta)
        flag_score = pc[:, :, None, 3:5].expand(-1, -1, J, -1)
        fused5 = torch.cat([jln.fused_poses, flag_score], dim=-1)
        return ModelOutputs(fused5, jln.plane_poses, pc, losses)

    def _losses(self, hdn: HDNOutputs, jln: JLNOutputs, mask: torch.Tensor,
                targets: Dict[str, torch.Tensor], meta: Dict[str, torch.Tensor]):
        """Training losses (reference faster_voxelpose.py:51-98, JAX
        package models/faster_voxelpose.py:239-300)."""
        tr = self.cfg.TRAIN
        J = self.cfg.DATASET.NUM_JOINTS
        gs = self.global_sum
        p2g = hdn.proposal_centers[:, :, 3].clamp(min=0.0).long()  # (B, K)

        # BEV center-heatmap MSE over the full map
        loss_2d = tr.LAMBDA_LOSS_2D * full_mean((hdn.heatmaps_2d - targets["2d_heatmaps"]) ** 2, gs)

        # 1D height MSE on matched proposals only
        t1d = targets["1d_heatmaps"]
        matched_1d = torch.gather(t1d, 1, p2g[..., None].expand(-1, -1, t1d.shape[-1]))
        sq = (hdn.heatmaps_1d - matched_1d) ** 2
        loss_1d = tr.LAMBDA_LOSS_1D * masked_mean(sq, mask[..., None], gs)

        # bbox-size L1 supervised at GT center positions
        gt_index = targets["index"].long()  # (B, Kgt)
        bbox_at_gt = torch.gather(hdn.bbox_maps, 1, gt_index[..., None].expand(-1, -1, 2))
        l1 = torch.abs(bbox_at_gt - targets["bbox"])
        loss_bbox = tr.LAMBDA_LOSS_BBOX * masked_mean(l1, targets["mask"][..., None], gs)

        # visibility-masked joint L1 per plane + weighted fused term
        gt_joints = meta["joints_3d"].float()  # (B, Kgt, J, 3)
        gt_vis = meta["joints_3d_vis"].float()  # (B, Kgt, J)
        jsel = torch.gather(gt_joints, 1, p2g[:, :, None, None].expand(-1, -1, J, 3))
        vis = torch.gather(gt_vis, 1, p2g[:, :, None].expand(-1, -1, J))[..., None]
        mkj = mask[:, :, None, None]

        def plane_l1(pred, gt2):
            return masked_mean(torch.abs(pred * vis - gt2 * vis), mkj, gs)

        # the xy, xz and yz planes, as slices: a list index would build a
        # tensor from host data, which a captured train step cannot hold
        loss_joint = (
            plane_l1(jln.plane_poses[0], jsel[..., 0:2])
            + plane_l1(jln.plane_poses[1], jsel[..., 0::2])
            + plane_l1(jln.plane_poses[2], jsel[..., 1:3])
            + tr.LAMBDA_LOSS_FUSED
            * masked_mean(torch.abs(jln.fused_poses * vis - jsel * vis), mkj, gs)
        )
        n_valid = mask.sum().float()
        if gs is not None:
            n_valid = gs(n_valid)
        loss_joint = torch.where(n_valid > 0, loss_joint, torch.zeros_like(loss_joint))
        return {
            "2d_heatmaps": loss_2d,
            "1d_heatmaps": loss_1d,
            "bbox": loss_bbox,
            "joint": loss_joint,
            "total": loss_2d + loss_1d + loss_bbox + loss_joint,
        }


def build_model(cfg: Config) -> FasterVoxelPoseNet:
    """The model in eval mode, for serving; training passes train=True."""
    return FasterVoxelPoseNet(cfg).eval()
