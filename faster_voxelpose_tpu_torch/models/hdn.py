"""Human Detection Network: whole-space cube -> per-person 3D center
proposals with confidences and bbox sizes (counterpart of
`faster_voxelpose_tpu/models/hdn.py`, reference
human_detection_net.py:25-104).  In train mode each proposal is matched
to its nearest ground-truth root instead of thresholded by score.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..ops.nms import nms2d_topk
from .cnns import C2CNet, CenterNet
from .projection import ProjectionGeometry, project_whole_batch, whole_axes


class HDNOutputs(NamedTuple):
    heatmaps_2d: torch.Tensor  # (B, X, Y) BEV center heatmap
    heatmaps_1d: torch.Tensor  # (B, K, Z) per-proposal height heatmaps
    bbox_maps: torch.Tensor  # (B, X*Y, 2) dense bbox-size regression
    proposal_centers: torch.Tensor  # (B, K, 7)
    feature_cubes: torch.Tensor  # (B, X, Y, Z, J) whole-space volume


def match_proposals_to_gt(
    centers_mm: torch.Tensor,  # (B, K, 3) proposal world centers
    bbox_preds: torch.Tensor,  # (B, K, 2)
    gt_roots: torch.Tensor,  # (B, Kgt, 3)
    gt_bbox: torch.Tensor,  # (B, Kgt, 2)
    num_person: torch.Tensor,  # (B,)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training-time matching: each proposal gets the index of its
    nearest valid GT root, or -1 beyond 500 mm; a matched bbox prediction
    that underestimates the GT bbox by more than 0.1 on either axis is
    replaced by the GT bbox (reference filter_proposal,
    human_detection_net.py:25-42).  Returns (proposal2gt (B, K) float,
    bbox (B, K, 2))."""
    Kgt = gt_roots.shape[1]
    arange = torch.arange(Kgt, device=gt_roots.device)
    gt_valid = arange[None, :] < num_person.reshape(-1, 1)  # (B, Kgt)
    diff = centers_mm[:, :, None, :] - gt_roots[:, None, :, :]
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1))  # (B, K, Kgt)
    dist = torch.where(gt_valid[:, None, :], dist, torch.full_like(dist, float("inf")))
    min_dist, min_gt = dist.min(dim=-1)  # the first minimum, as jnp.argmin
    proposal2gt = torch.where(min_dist > 500.0, torch.full_like(min_dist, -1.0), min_gt.float())
    matched = torch.gather(gt_bbox, 1, min_gt[..., None].expand(-1, -1, 2))
    underestimates = (bbox_preds < matched - 0.1).any(dim=-1)
    replace = (proposal2gt >= 0) & underestimates
    return proposal2gt, torch.where(replace[..., None], matched, bbox_preds)


class HumanDetectionNet(nn.Module):
    def __init__(self, geom: ProjectionGeometry, num_joints: int, max_people: int,
                 min_score: float, dtype=torch.float32, width: float = 1.0):
        super().__init__()
        self.geom, self.max_people, self.min_score = geom, max_people, min_score
        self.center_net = CenterNet(num_joints, dtype=dtype, width=width)
        self.c2c_net = C2CNet(num_joints, dtype=dtype, width=width)
        for name, axis in zip(("whole_gx", "whole_gy", "whole_gz"), whole_axes(geom)):
            self.register_buffer(name, torch.as_tensor(axis), persistent=False)
        space = torch.tensor(geom.space_size, dtype=torch.float32)
        voxn = torch.tensor(geom.voxels_per_axis, dtype=torch.float32)
        center = torch.tensor(geom.space_center, dtype=torch.float32)
        self.register_buffer("vox_scale", space / (voxn - 1), persistent=False)
        self.register_buffer("vox_bias", center - space / 2.0, persistent=False)

    def forward(self, heatmaps: torch.Tensor, cams: torch.Tensor, train: bool = False,
                gt_roots: Optional[torch.Tensor] = None,
                gt_bbox: Optional[torch.Tensor] = None,
                num_person: Optional[torch.Tensor] = None) -> HDNOutputs:
        """heatmaps (B, V, H, W, J), cams (B, V, 21); in train mode with
        gt_roots (B, Kgt, 3), gt_bbox (B, Kgt, 2) and num_person (B,) the
        proposals are matched to the ground truth."""
        B, K = cams.shape[0], self.max_people
        vx, vy, vz = self.geom.voxels_per_axis
        cubes = project_whole_batch(self.geom, heatmaps, cams,
                                    (self.whole_gx, self.whole_gy, self.whole_gz))

        hm, size = self.center_net(cubes, train)
        hm2d = hm[:, 0]
        # proposal selection carries no gradient (human_detection_net.py:85)
        confs2d, idx2d, flat2d = nms2d_topk(hm2d.detach(), K)

        bbox_flat = size.permute(0, 2, 3, 1).reshape(B, vx * vy, 2)
        match_bbox = torch.gather(bbox_flat, 1, flat2d[..., None].expand(-1, -1, 2))

        # per-proposal z-columns (B, K, Z, J) -> C2CNet over (B*K, J, Z)
        cube_flat = cubes.reshape(B, vx * vy, vz, -1)
        cols = cube_flat[torch.arange(B, device=cubes.device)[:, None], flat2d]
        hm1d = self.c2c_net(cols.reshape(B * K, vz, -1).transpose(1, 2), train).reshape(B, K, vz)

        hm1d_d = hm1d.detach()
        conf1d = hm1d_d.amax(dim=-1)
        idx1d = hm1d_d.argmax(dim=-1)  # first maximum, as jnp.argmax

        voxel_idx = torch.cat([idx2d, idx1d[..., None]], dim=-1)
        centers_mm = voxel_idx.float() * self.vox_scale + self.vox_bias
        confs = confs2d * conf1d
        if train and gt_roots is not None:
            proposal2gt, match_bbox = match_proposals_to_gt(
                centers_mm, match_bbox, gt_roots, gt_bbox, num_person
            )
        else:
            proposal2gt = (confs > self.min_score).float() - 1.0
        proposal_centers = torch.cat(
            [centers_mm, proposal2gt[..., None], confs[..., None], match_bbox], dim=-1
        )
        return HDNOutputs(hm2d, hm1d, bbox_flat, proposal_centers, cubes)
