"""What the fusion models share: the compute dtypes by name, and the
outputs of a forward."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16, "float16": torch.float16}


class ModelOutputs(NamedTuple):
    fused_poses: torch.Tensor  # (B, K, J, 5): xyz, validity flag, score
    plane_poses: Optional[torch.Tensor]  # (3, B, K, J, 2); None for VoxelPose
    proposal_centers: torch.Tensor  # (B, K, 7); (B, K, 5) for VoxelPose
    losses: Optional[Dict[str, torch.Tensor]]
