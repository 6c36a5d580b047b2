"""BEV proposal decoding: max-pool-equality NMS + top-k (counterpart of
`faster_voxelpose_tpu/ops/nms.py`, reference lib/core/proposal.py)."""

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
