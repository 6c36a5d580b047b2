"""Multi-view heatmap back-projection into voxel feature volumes
(counterpart of `faster_voxelpose_tpu/models/projection.py`).

Whole-space stage: the static world grid is projected into every view on
the device and sampled by the `sample_whole` kernel into the (X, Y, Z, J)
cube.  Per-person stage: each proposal's 64^3 crop is rebuilt from its
integer origin on the virtual fine grid and projected, sampled, masked
and max-projected onto three planes inside the `sample_crop_planes`
kernel, so no crop cube is ever stored.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import Config
from ..geometry.grids import (
    compute_center_grids_np,
    compute_grid_np,
    norm_to_pixel,
    project_to_norm_coords,
)
from ..geometry.transforms import get_resize_transform
from ..ops.sampling_kernels import CropProjection, sample_crop_planes, sample_whole


class ProjectionGeometry(NamedTuple):
    """Static geometry constants derived from a Config."""

    ori_image_size: Tuple[int, int]
    image_size: Tuple[int, int]
    heatmap_size: Tuple[int, int]
    resize_transform: np.ndarray  # (2, 3)
    space_size: Tuple[float, float, float]
    space_center: Tuple[float, float, float]
    voxels_per_axis: Tuple[int, int, int]
    whole_grid: np.ndarray  # (Nbins, 3) world coords, f32
    ind_space_size: Tuple[float, float, float]
    ind_voxels_per_axis: Tuple[int, int, int]
    fine_voxels_per_axis: Tuple[int, int, int]
    center_grids: np.ndarray  # (3, P, 2) soft-argmax plane coords, f32
    # crop-origin affine: tl = round(center * scale + bias)
    fine_scale: np.ndarray  # (3,) f32
    fine_bias: np.ndarray  # (3,) f32


def make_projection_geometry(cfg: Config) -> ProjectionGeometry:
    cs, ind = cfg.CAPTURE_SPEC, cfg.INDIVIDUAL_SPEC
    fine = cfg.fine_voxels_per_axis
    whole_grid = compute_grid_np(cs.SPACE_SIZE, cs.SPACE_CENTER, cs.VOXELS_PER_AXIS)
    center_grids = compute_center_grids_np(
        ind.SPACE_SIZE, cs.SPACE_CENTER, ind.VOXELS_PER_AXIS
    )
    # crop-origin mapping (reference project_individual.py:28-30)
    space = np.asarray(cs.SPACE_SIZE)
    center = np.asarray(cs.SPACE_CENTER)
    ind_size = np.asarray(ind.SPACE_SIZE)
    fine_arr = np.asarray(fine, dtype=np.float64)
    scale = (fine_arr - 1) / space
    bias = -ind_size / 2.0 / space * (fine_arr - 1) - scale * (center - space / 2.0)
    return ProjectionGeometry(
        ori_image_size=cfg.DATASET.ORI_IMAGE_SIZE,
        image_size=cfg.DATASET.IMAGE_SIZE,
        heatmap_size=cfg.DATASET.HEATMAP_SIZE,
        resize_transform=get_resize_transform(
            cfg.DATASET.ORI_IMAGE_SIZE, cfg.DATASET.IMAGE_SIZE
        ),
        space_size=cs.SPACE_SIZE,
        space_center=cs.SPACE_CENTER,
        voxels_per_axis=cs.VOXELS_PER_AXIS,
        whole_grid=whole_grid.astype(np.float32),
        ind_space_size=ind.SPACE_SIZE,
        ind_voxels_per_axis=ind.VOXELS_PER_AXIS,
        fine_voxels_per_axis=fine,
        center_grids=center_grids.astype(np.float32),
        fine_scale=scale.astype(np.float32),
        fine_bias=bias.astype(np.float32),
    )


def crop_projection(geom: ProjectionGeometry) -> CropProjection:
    """Kernel constants of the crop projection: fine index i lies at
    (center - S/2) + i * S/(F-1), all in float32 as the JAX package
    computes them."""
    space = np.asarray(geom.space_size, np.float32)
    center = np.asarray(geom.space_center, np.float32)
    fine = np.asarray(geom.fine_voxels_per_axis, np.float32)
    step = space / (fine - np.float32(1.0))
    origin = center - space / np.float32(2.0)
    rt = np.asarray(geom.resize_transform, np.float32).ravel()
    return CropProjection(
        origin=tuple(float(v) for v in origin),
        step=tuple(float(v) for v in step),
        resize_transform=tuple(float(v) for v in rt),
        ori_image_size=tuple(geom.ori_image_size),
        image_size=tuple(geom.image_size),
        heatmap_size=tuple(geom.heatmap_size),
    )


def whole_pixels(
    geom: ProjectionGeometry, grid: torch.Tensor, cams: torch.Tensor
) -> torch.Tensor:
    """World grid (N, 3), cams (V, 21) -> heatmap pixel coords (V, N, 2),
    as project_whole_pallas computes them (models/projection.py:371-378
    of the JAX package)."""
    norm = project_to_norm_coords(
        grid, cams, geom.resize_transform, geom.ori_image_size,
        geom.image_size, geom.heatmap_size,
    )
    return norm_to_pixel(norm, geom.heatmap_size).contiguous()


def project_whole(
    geom: ProjectionGeometry,
    heatmaps: torch.Tensor,  # (V, H, W, J)
    cams: torch.Tensor,  # (V, 21)
    grid: torch.Tensor,  # (N, 3) geom.whole_grid on the heatmaps' device
) -> torch.Tensor:
    """One sample's whole-space cube (X, Y, Z, J): view mean of the
    bilinear samples, clamped to [0, 1] (reference project_whole.py:62-88)."""
    vals = sample_whole(heatmaps.contiguous(), whole_pixels(geom, grid, cams))
    vx, vy, vz = geom.voxels_per_axis
    return vals.reshape(vx, vy, vz, -1)


def compute_crop_origin(
    geom: ProjectionGeometry, centers_mm: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integer crop origin on the virtual fine grid (round half to even,
    as jnp.round) and the crop's mm offset (reference
    project_individual.py:110-111)."""
    dev = centers_mm.device
    scale = torch.as_tensor(geom.fine_scale, device=dev)
    bias = torch.as_tensor(geom.fine_bias, device=dev)
    fine = torch.tensor(geom.fine_voxels_per_axis, dtype=torch.float32, device=dev)
    space = torch.tensor(geom.space_size, dtype=torch.float32, device=dev)
    ind = torch.tensor(geom.ind_space_size, dtype=torch.float32, device=dev)
    tl = torch.round(centers_mm.float() * scale + bias).to(torch.int32)
    offset = tl.float() / (fine - 1) * space - space / 2.0 + ind / 2.0
    return tl, offset


def crop_axis_masks(
    geom: ProjectionGeometry, centers_tl: torch.Tensor, bbox_sizes: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-axis factors mx (K, vx), my (K, vy), mz (K, vz) of the separable
    crop mask that zeroes voxels outside the predicted bbox or the capture
    volume (reference project_individual.py:114-121)."""
    dev = centers_tl.device
    vox = torch.tensor(geom.ind_voxels_per_axis, dtype=torch.int32, device=dev)
    fine = torch.tensor(geom.fine_voxels_per_axis, dtype=torch.int32, device=dev)
    margin_xy = ((1.0 - bbox_sizes.float()) / 2.0 * (vox[:2].float() - 1)).to(torch.int32)
    margin = torch.cat(
        [margin_xy.clamp(min=0), torch.zeros_like(margin_xy[:, :1])], dim=1
    )
    start = (centers_tl + margin).clamp(min=0)
    end = torch.minimum(centers_tl + vox - margin, fine)
    masks = []
    for a in range(3):
        f = centers_tl[:, a:a + 1] + torch.arange(
            geom.ind_voxels_per_axis[a], dtype=torch.int32, device=dev
        )
        masks.append((f >= start[:, a:a + 1]) & (f < end[:, a:a + 1]))
    return masks[0], masks[1], masks[2]


def project_individual_planes(
    geom: ProjectionGeometry,
    heatmaps: torch.Tensor,  # (V, H, W, J)
    cams: torch.Tensor,  # (V, 21)
    centers_tl: torch.Tensor,  # (K, 3) int32
    bbox_sizes: torch.Tensor,  # (K, 2)
    valid: torch.Tensor,  # (K,) bool; invalid slots give zero planes
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-person plane projections (xy (K,X,Y,J), xz (K,X,Z,J),
    yz (K,Y,Z,J)) of the bbox-masked crop cubes
    (joint_localization_net.py:80-81)."""
    mx, my, mz = crop_axis_masks(geom, centers_tl, bbox_sizes)
    u8 = torch.uint8
    return sample_crop_planes(
        heatmaps.contiguous(), cams.float().contiguous(),
        centers_tl.to(torch.int32).contiguous(),
        mx.to(u8), my.to(u8), mz.to(u8), valid.to(u8).contiguous(),
        crop_projection(geom),
    )
