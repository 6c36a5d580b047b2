"""Human Detection Network, inference: whole-space cube -> per-person 3D
center proposals with confidences and bbox sizes (counterpart of
`faster_voxelpose_tpu/models/hdn.py:80-154`, reference
human_detection_net.py:67-104).

Training-time GT matching (`match_proposals_to_gt`) belongs to the
training slice and is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..ops.nms import nms2d_topk
from .cnns import C2CNet, CenterNet
from .projection import ProjectionGeometry, project_whole


class HDNOutputs(NamedTuple):
    heatmaps_2d: torch.Tensor  # (B, X, Y) BEV center heatmap
    heatmaps_1d: torch.Tensor  # (B, K, Z) per-proposal height heatmaps
    bbox_maps: torch.Tensor  # (B, X*Y, 2) dense bbox-size regression
    proposal_centers: torch.Tensor  # (B, K, 7)
    feature_cubes: torch.Tensor  # (B, X, Y, Z, J) whole-space volume


class HumanDetectionNet(nn.Module):
    def __init__(self, geom: ProjectionGeometry, num_joints: int, max_people: int,
                 min_score: float, dtype=torch.float32, width: float = 1.0):
        super().__init__()
        self.geom, self.max_people, self.min_score = geom, max_people, min_score
        self.center_net = CenterNet(num_joints, dtype=dtype, width=width)
        self.c2c_net = C2CNet(num_joints, dtype=dtype, width=width)
        self.register_buffer(
            "whole_grid", torch.as_tensor(geom.whole_grid), persistent=False
        )
        space = torch.tensor(geom.space_size, dtype=torch.float32)
        voxn = torch.tensor(geom.voxels_per_axis, dtype=torch.float32)
        center = torch.tensor(geom.space_center, dtype=torch.float32)
        self.register_buffer("vox_scale", space / (voxn - 1), persistent=False)
        self.register_buffer("vox_bias", center - space / 2.0, persistent=False)

    def forward(self, heatmaps: torch.Tensor, cams: torch.Tensor) -> HDNOutputs:
        """heatmaps (B, V, H, W, J), cams (B, V, 21)."""
        B, K = cams.shape[0], self.max_people
        vx, vy, vz = self.geom.voxels_per_axis
        cubes = torch.stack([
            project_whole(self.geom, heatmaps[b], cams[b], self.whole_grid)
            for b in range(B)
        ])  # (B, X, Y, Z, J)

        hm, size = self.center_net(cubes)
        hm2d = hm[:, 0]
        confs2d, idx2d, flat2d = nms2d_topk(hm2d, K)

        bbox_flat = size.permute(0, 2, 3, 1).reshape(B, vx * vy, 2)
        match_bbox = torch.gather(bbox_flat, 1, flat2d[..., None].expand(-1, -1, 2))

        # per-proposal z-columns (B, K, Z, J) -> C2CNet over (B*K, J, Z)
        cube_flat = cubes.reshape(B, vx * vy, vz, -1)
        cols = cube_flat[torch.arange(B, device=cubes.device)[:, None], flat2d]
        hm1d = self.c2c_net(cols.reshape(B * K, vz, -1).transpose(1, 2)).reshape(B, K, vz)

        conf1d = hm1d.amax(dim=-1)
        idx1d = hm1d.argmax(dim=-1)  # first maximum, as jnp.argmax

        voxel_idx = torch.cat([idx2d, idx1d[..., None]], dim=-1)
        centers_mm = voxel_idx.float() * self.vox_scale + self.vox_bias
        confs = confs2d * conf1d
        proposal2gt = (confs > self.min_score).float() - 1.0
        proposal_centers = torch.cat(
            [centers_mm, proposal2gt[..., None], confs[..., None], match_bbox], dim=-1
        )
        return HDNOutputs(hm2d, hm1d, bbox_flat, proposal_centers, cubes)
