"""Soft-argmax decoding over orthographic plane heatmaps (counterpart of
`faster_voxelpose_tpu/ops/soft_argmax.py`, reference SoftArgmaxLayer)."""

from __future__ import annotations

from typing import Tuple

import torch


def soft_argmax(
    plane_features: torch.Tensor, center_grids: torch.Tensor, beta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """plane_features (3, N, J, P), center_grids (3, P, 2) world mm.

    Returns poses (3, N, J, 2), the expectation of each plane's grid
    under a temperature-beta softmax, and confs (N,), the mean over
    planes and joints of the largest probability.  Everything runs in
    float32; the expectation is an elementwise product and sum, never a
    matmul that TF32 could round, since it contracts probabilities
    against mm-scale coordinates."""
    x = torch.softmax(beta * plane_features.float(), dim=-1)
    confs = x.amax(dim=-1).mean(dim=(0, 2))
    grid = center_grids.float()
    poses = torch.stack(
        [
            (x * grid[:, None, None, :, 0]).sum(-1),
            (x * grid[:, None, None, :, 1]).sum(-1),
        ],
        dim=-1,
    )
    return poses, confs
