"""Top-level FasterVoxelPose model, inference (counterpart of
`faster_voxelpose_tpu/models/faster_voxelpose.py:163-237`, reference
faster_voxelpose.py:18-105): HDN then JLN on heatmaps and a packed rig,
with the same `ModelOutputs` layout.  The training losses belong to the
training slice and are not ported yet.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from ..config import Config
from .hdn import HumanDetectionNet
from .jln import JointLocalizationNet
from .projection import make_projection_geometry

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


class ModelOutputs(NamedTuple):
    fused_poses: torch.Tensor  # (B, K, J, 5): xyz, validity flag, score
    plane_poses: torch.Tensor  # (3, B, K, J, 2)
    proposal_centers: torch.Tensor  # (B, K, 7)
    losses: Optional[Dict[str, torch.Tensor]]


class FasterVoxelPoseNet(nn.Module):
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
            dtype=dtype, width=width,
        )

    def forward(self, heatmaps: torch.Tensor, cams: torch.Tensor) -> ModelOutputs:
        """heatmaps (B, V, H, W, J) float32, cams (B, V, 21) float32."""
        J = self.cfg.DATASET.NUM_JOINTS
        heatmaps, cams = heatmaps.float(), cams.float()
        hdn = self.hdn(heatmaps, cams)
        mask = hdn.proposal_centers[:, :, 3] >= 0
        jln = self.jln(heatmaps, cams, hdn.proposal_centers)

        # eval-time confidence refresh (reference
        # joint_localization_net.py:98)
        pc = hdn.proposal_centers.clone()
        pc[:, :, 4] = torch.where(mask, jln.confidences, pc[:, :, 4])
        flag_score = pc[:, :, None, 3:5].expand(-1, -1, J, -1)
        fused5 = torch.cat([jln.fused_poses, flag_score], dim=-1)
        return ModelOutputs(fused5, jln.plane_poses, pc, None)


def build_model(cfg: Config) -> FasterVoxelPoseNet:
    return FasterVoxelPoseNet(cfg).eval()
