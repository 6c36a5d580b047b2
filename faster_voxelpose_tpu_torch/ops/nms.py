"""Proposal decoding: max-pool-equality NMS + top-k, on Faster VoxelPose's
BEV map (counterpart of `faster_voxelpose_tpu/ops/nms.py`, reference
lib/core/proposal.py) and on VoxelPose's root cube (`nms3d_topk`,
voxelpose-pytorch lib/core/proposal.py)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def maxpool_nms_2d(prob_map: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Keep only local maxima of (B, H, W) under a kernel x kernel window;
    non-peaks are zeroed (max_pool2d pads with -inf)."""
    pooled = F.max_pool2d(
        prob_map[:, None], kernel, stride=1, padding=(kernel - 1) // 2
    )[:, 0]
    return torch.where(prob_map == pooled, prob_map, torch.zeros_like(prob_map))


def nms2d_topk(
    prob_map: torch.Tensor, max_num: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """NMS + flatten + top-k.

    Returns (values (B, K), index (B, K, 2) as (row, col), flat index
    (B, K)).  `torch.topk` promises no order among equal values, so a
    stable descending sort picks them: ties go to the lower flat index,
    as `lax.top_k` breaks them."""
    B, H, W = prob_map.shape
    flat = maxpool_nms_2d(prob_map).reshape(B, H * W)
    values, order = torch.sort(flat, dim=1, descending=True, stable=True)
    values, topk_flat = values[:, :max_num], order[:, :max_num]
    index = torch.stack([topk_flat // W, topk_flat % W], dim=-1)
    return values, index, topk_flat


def nms3d_topk(root_cubes: torch.Tensor, max_num: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """VoxelPose's proposals: (B, X, Y, Z) root cubes, only the voxels equal
    to their 3x3x3 max-pool kept (the others zeroed), flattened, top-k.

    Returns (values (B, K), index (B, K, 3) as (x, y, z), flat index
    (B, K)); ties go to the lower flat index, as in `nms2d_topk`."""
    B, X, Y, Z = root_cubes.shape
    pooled = F.max_pool3d(root_cubes[:, None], 3, stride=1, padding=1)[:, 0]
    kept = torch.where(root_cubes == pooled, root_cubes, torch.zeros_like(root_cubes))
    values, order = torch.sort(kept.reshape(B, -1), dim=1, descending=True, stable=True)
    values, flat = values[:, :max_num], order[:, :max_num]
    index = torch.stack([flat // (Y * Z), flat // Z % Y, flat % Z], dim=-1)
    return values, index, flat
