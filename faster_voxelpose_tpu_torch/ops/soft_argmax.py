"""Soft-argmax decoding over orthographic plane heatmaps (counterpart of
`faster_voxelpose_tpu/ops/soft_argmax.py`, reference SoftArgmaxLayer), and
over VoxelPose's joint cubes (`soft_argmax_3d`)."""

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


def soft_argmax_3d(cubes: torch.Tensor, axes: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                   beta: float) -> torch.Tensor:
    """VoxelPose's SoftArgmaxLayer: cubes (N, J, X, Y, Z), the grid's
    offsets along each axis (X,), (Y,), (Z,) mm -> (N, J, 3), the
    expectation of the grid under a softmax of beta * cube over its
    voxels.  The grid is separable, so each coordinate is taken from its
    axis' marginal; all in float32, with no matmul."""
    N, J, X, Y, Z = cubes.shape
    p = torch.softmax(beta * cubes.float().reshape(N, J, -1), dim=-1).reshape(N, J, X, Y, Z)
    marginals = (p.sum(dim=(3, 4)), p.sum(dim=(2, 4)), p.sum(dim=(2, 3)))
    return torch.stack([(m * a.float()).sum(-1) for m, a in zip(marginals, axes)], dim=-1)
