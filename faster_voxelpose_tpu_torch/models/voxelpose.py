"""VoxelPose (Tu, Wang and Zeng, ECCV 2020; voxelpose-pytorch
lib/models/{v2v_net, cuboid_proposal_net, pose_regression_net,
project_layer, multi_person_posenet}.py), served beside Faster VoxelPose:
`models.build_fusion_model` returns it where `cfg.MODEL` is "voxelpose".

- **CPN** (cuboid proposal network): the whole-space cube (B, X, Y, Z, J)
  by the ProjectLayer (`sample_whole_projected` in its bounded mode: the
  view sum over the views whose original image holds the voxel, over
  their count plus 1e-6, clamped), `V2VNet(J, 1)` to the root cube, 3x3x3
  max-pool NMS and the top K (`ops.nms.nms3d_topk`); each index becomes
  its voxel's centre in world mm, flagged valid where its value passes
  CAPTURE_SPEC.MIN_SCORE (VoxelPose's THRESHOLD).
- **PRN** (pose regression network): for each of the K proposals the
  (J, 64, 64, 64) cube on linspace(-S/2, S/2, 64) about its centre per
  axis (`sample_crop_cube` with `centres`, bounded, no bbox mask),
  `V2VNet(J, J)`, and a soft-argmax at temperature BETA over the cube's
  voxels (`ops.soft_argmax.soft_argmax_3d`).  Every slot runs, valid or
  not, so that the graph has one shape; the upstream runs the valid
  cubes alone, and the answers for valid people are the same.
- **V2VNet(cin, cout)**: `blocks.UNetFront` and `blocks.EncoderDecoder`
  at rank 3 (Basic3DBlock 7^3 to 16, Res3DBlock to 32, the encoder-decoder
  32-64-128-64-32), then a 1^3 conv to cout whose sums are float32.

The output is Faster VoxelPose's `fused5` layout, (B, K, J, 5): xyz, the
proposal's flag (0 valid, -1 not) and its CPN value, which
`PoseService._decode` reads as it is; `proposal_centers` is (B, K, 5),
VoxelPose's grid centres.  Served only: train mode raises.  For serving,
`FoldedModule.fold()` (label "voxelpose") folds every BatchNorm into its
convolution, in the compute dtype, as it does for the other models.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..ops.nms import nms3d_topk
from ..ops.sampling_kernels import centred_projection, sample_crop_cube, sample_whole_projected
from ..ops.soft_argmax import soft_argmax_3d
from ..utils import profiling
from .blocks import Conv, EncoderDecoder, FoldedModule, UNetFront
from .common import DTYPES, ModelOutputs
from .projection import crop_projection, make_projection_geometry, whole_axes, whole_projection


class V2VNet(nn.Module):
    """VoxelPose's V2VNet: (N, cin, X, Y, Z) -> (N, cout, X, Y, Z) float32."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32):
        super().__init__()
        self.front = UNetFront(cin, 3, dtype)
        self.encdec = EncoderDecoder(3, dtype)
        self.output = Conv(32, cout, 1, 3, dtype, float32_out=True)

    def forward(self, x, train: bool = False):
        return self.output(self.encdec(self.front(x, train), train), train).float()


class VoxelPoseNet(FoldedModule):
    FOLD_LABEL = "voxelpose"

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.geom = geom = make_projection_geometry(cfg)
        dtype = DTYPES[cfg.NETWORK.COMPUTE_DTYPE]
        J, K = cfg.DATASET.NUM_JOINTS, cfg.CAPTURE_SPEC.MAX_PEOPLE
        self.max_people, self.threshold, self.beta = K, cfg.CAPTURE_SPEC.MIN_SCORE, cfg.NETWORK.BETA
        self.cpn = V2VNet(J, 1, dtype)
        self.prn = V2VNet(J, J, dtype)
        self.whole = whole_projection(geom)
        ind = cfg.INDIVIDUAL_SPEC
        self.crop = centred_projection(crop_projection(geom), ind.SPACE_SIZE, ind.VOXELS_PER_AXIS)
        for name, axis in zip(("whole_gx", "whole_gy", "whole_gz"), whole_axes(geom)):
            self.register_buffer(name, torch.as_tensor(axis), persistent=False)
        # voxel index -> world mm, in the upstream's order (get_real_loc)
        f32 = dict(dtype=torch.float32)
        cs = cfg.CAPTURE_SPEC
        self.register_buffer("vox_den", torch.tensor(cs.VOXELS_PER_AXIS, **f32) - 1,
                             persistent=False)
        self.register_buffer("space_size", torch.tensor(cs.SPACE_SIZE, **f32), persistent=False)
        self.register_buffer("space_center", torch.tensor(cs.SPACE_CENTER, **f32),
                             persistent=False)
        # a PRN cube's grid offsets per axis, (origin + i * step) in float32
        # as the crop kernel forms them, and its all-true axis masks
        for a, (name, n) in enumerate(zip(("ind_gx", "ind_gy", "ind_gz"), ind.VOXELS_PER_AXIS)):
            g = np.float32(self.crop.origin[a]) + np.arange(n, dtype=np.float32) * np.float32(
                self.crop.step[a])
            self.register_buffer(name, torch.as_tensor(g), persistent=False)
        for name, n in zip(("mask_x", "mask_y", "mask_z"), ind.VOXELS_PER_AXIS):
            self.register_buffer(name, torch.ones((K, n), dtype=torch.uint8), persistent=False)
        self.register_buffer("all_slots", torch.ones(K, dtype=torch.uint8), persistent=False)

    def proposals(self, heatmaps: torch.Tensor, cams: torch.Tensor):
        """The CPN: (values (B, K), centres (B, K, 3) mm) of the root cube's
        top K after NMS."""
        cubes = sample_whole_projected(heatmaps, cams, (self.whole_gx, self.whole_gy,
                                                        self.whole_gz), self.whole, bounded=True)
        root = self.cpn(cubes.permute(0, 4, 1, 2, 3))[:, 0]
        values, index, _ = nms3d_topk(root, self.max_people)
        centres = index.float() / self.vox_den * self.space_size + self.space_center \
            - self.space_size / 2.0
        return values, centres

    def regress(self, heatmaps: torch.Tensor, cams: torch.Tensor, centres: torch.Tensor):
        """The PRN over every slot: poses (B, K, J, 3) mm."""
        B, K, J = centres.shape[0], self.max_people, self.cfg.DATASET.NUM_JOINTS
        cubes = torch.cat([
            sample_crop_cube(heatmaps[b].contiguous(), self.mask_x, self.mask_y, self.mask_z,
                             self.all_slots, cams=cams[b].contiguous(), crop=self.crop,
                             centres=centres[b].contiguous())
            for b in range(B)])  # (B * K, X, Y, Z, J)
        y = self.prn(cubes.permute(0, 4, 1, 2, 3))
        c = centres.reshape(B * K, 1, 3)
        axes = tuple(g + c[..., a, None] for a, g in
                     enumerate((self.ind_gx, self.ind_gy, self.ind_gz)))
        return soft_argmax_3d(y, axes, self.beta).reshape(B, K, J, 3)

    def forward(self, heatmaps: torch.Tensor, cams: torch.Tensor, train: bool = False
                ) -> ModelOutputs:
        """heatmaps (B, V, H, W, J) float32, cams (B, V, 21) float32."""
        if train or self.training:
            raise NotImplementedError("VoxelPose is served here, not trained")
        self.serving(heatmaps)  # refolds first where a tensor moved
        heatmaps, cams = heatmaps.float().contiguous(), cams.float().contiguous()
        J = self.cfg.DATASET.NUM_JOINTS
        values, centres = self.proposals(heatmaps, cams)
        flag = (values > self.threshold).float() - 1.0
        profiling.mark("cpn")  # a no-op except in a service's graph capture
        poses = self.regress(heatmaps, cams, centres)
        flag_score = torch.stack([flag, values], dim=-1)  # (B, K, 2)
        fused5 = torch.cat([poses, flag_score[:, :, None].expand(-1, -1, J, -1)], dim=-1)
        return ModelOutputs(fused5, None, torch.cat([centres, flag_score], dim=-1), None)


def build_voxelpose(cfg: Config) -> VoxelPoseNet:
    """The model in eval mode, for serving."""
    return VoxelPoseNet(cfg).eval()
