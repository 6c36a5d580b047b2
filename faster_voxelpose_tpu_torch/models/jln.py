"""Joint Localization Network, inference: per-proposal plane projections
-> P2PNet -> soft-argmax -> learned per-joint plane fusion (counterpart
of `faster_voxelpose_tpu/models/jln.py`, reference
joint_localization_net.py:36-100).  Invalid proposal slots are skipped
by the crop kernel and their outputs multiplied to zero.  In train mode
their zero planes enter P2PNet's batch statistics, as in the JAX
package (models/projection.py:299-304).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..ops.soft_argmax import soft_argmax
from .cnns import P2PNet, WeightNet
from .projection import (
    DEFAULT_CROP_ROUTE,
    CropRoute,
    CropConstants,
    ProjectionGeometry,
    compute_crop_origin,
    crop_constants,
    project_individual_planes,
)


class JLNOutputs(NamedTuple):
    fused_poses: torch.Tensor  # (B, K, J, 3) world mm
    plane_poses: torch.Tensor  # (3, B, K, J, 2) per-plane 2D estimates
    confidences: torch.Tensor  # (B, K) soft-argmax confidences


def fuse_plane_poses(plane_poses: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted fusion of the three plane estimates (3, N, J, 2) with
    weights (3, N, J, 1) into xyz (N, J, 3): each world axis appears in
    two planes, whose weights are normalized (reference fuse_pose_preds,
    joint_localization_net.py:44-62)."""
    xy_w, xz_w, yz_w = weights[0, ..., 0], weights[1, ..., 0], weights[2, ..., 0]
    xy, xz, yz = plane_poses[0], plane_poses[1], plane_poses[2]

    def blend(wa, wb, a, b):
        return (wa * a + wb * b) / (wa + wb)

    x = blend(xy_w, xz_w, xy[..., 0], xz[..., 0])
    y = blend(xy_w, yz_w, xy[..., 1], yz[..., 0])
    z = blend(xz_w, yz_w, xz[..., 1], yz[..., 1])
    return torch.stack([x, y, z], dim=-1)


class JointLocalizationNet(nn.Module):
    def __init__(self, geom: ProjectionGeometry, max_people: int, beta: float,
                 num_joints: int, weight_feat_channels: int = 32,
                 weight_hidden_channels: int = 64, dtype=torch.float32,
                 width: float = 1.0, crop_route: CropRoute = DEFAULT_CROP_ROUTE):
        super().__init__()
        self.geom, self.max_people, self.beta = geom, max_people, beta
        self.crop_route = crop_route
        self.num_joints = num_joints
        self.p2p_net = P2PNet(num_joints, num_joints, dtype=dtype, width=width)
        self.weight_net = WeightNet(
            weight_feat_channels, weight_hidden_channels, dtype=dtype
        )
        self.register_buffer(
            "center_grids", torch.as_tensor(geom.center_grids), persistent=False
        )
        # the crop stage's constants live on the module's device, so that
        # the forward copies nothing from the host and a CUDA graph can
        # hold it
        for name, value in crop_constants(geom)._asdict().items():
            self.register_buffer(f"crop_{name}", value, persistent=False)

    def forward(self, heatmaps: torch.Tensor, cams: torch.Tensor,
                proposal_centers: torch.Tensor, train: bool = False) -> JLNOutputs:
        geom = self.geom
        proposal_centers = proposal_centers.detach()
        B, K, J = cams.shape[0], self.max_people, self.num_joints
        vx, vy, vz = geom.ind_voxels_per_axis
        n = B * K
        mask = proposal_centers[:, :, 3] >= 0  # (B, K)
        consts = CropConstants(*(getattr(self, f"crop_{f}") for f in CropConstants._fields))
        centers_tl, offsets = compute_crop_origin(geom, proposal_centers[..., :3], consts)
        bbox_sizes = proposal_centers[..., 5:7]

        per_sample = [
            project_individual_planes(
                geom, heatmaps[b], cams[b], centers_tl[b], bbox_sizes[b], mask[b],
                self.crop_route, consts,
            )
            for b in range(B)
        ]
        plane_xy = torch.cat([p[0] for p in per_sample]).reshape(n, vx, vy, J)
        plane_xz = torch.cat([p[1] for p in per_sample]).reshape(n, vx, vz, J)
        plane_yz = torch.cat([p[2] for p in per_sample]).reshape(n, vy, vz, J)
        planes = torch.cat([plane_xy, plane_xz, plane_yz]).permute(0, 3, 1, 2)

        feats = self.p2p_net(planes, train)  # (3n, J, X, Y)
        plane_poses, confs = soft_argmax(
            feats.reshape(3, n, J, -1), self.center_grids, self.beta
        )  # (3, n, J, 2), (n,)

        off = offsets.reshape(n, 1, 3)  # sliced, not indexed by lists: no host index tensors
        plane_poses = plane_poses + torch.stack(
            [off[..., 0:2], off[..., 0:3:2], off[..., 1:3]]
        )

        weights = self.weight_net(feats, train).reshape(3, n, J, 1)
        fused = fuse_plane_poses(plane_poses, weights)

        m = mask.reshape(n, 1, 1).float()
        fused = (fused * m).reshape(B, K, J, 3)
        plane_poses = (plane_poses * m[None]).reshape(3, B, K, J, 2)
        confs = (confs * mask.reshape(n)).reshape(B, K)
        return JLNOutputs(fused, plane_poses, confs)
