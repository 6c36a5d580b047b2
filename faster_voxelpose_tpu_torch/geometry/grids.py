"""Voxel-grid geometry: world-coordinate grids and the world->normalized
heatmap-coordinate mapping shared by the whole-space and per-person
projection stages (counterpart of `faster_voxelpose_tpu/geometry/grids.py`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .cameras import project_points


def compute_grid_np(
    box_size: Tuple[float, float, float],
    box_center: Tuple[float, float, float],
    n_bins: Tuple[int, int, int],
) -> np.ndarray:
    """World coordinates of an axis-aligned voxel grid, (Nx*Ny*Nz, 3),
    x-major flattening (reference project_whole.compute_grid)."""
    gx = np.linspace(-box_size[0] / 2, box_size[0] / 2, n_bins[0]) + box_center[0]
    gy = np.linspace(-box_size[1] / 2, box_size[1] / 2, n_bins[1]) + box_center[1]
    gz = np.linspace(-box_size[2] / 2, box_size[2] / 2, n_bins[2]) + box_center[2]
    mx, my, mz = np.meshgrid(gx, gy, gz, indexing="ij")
    return np.stack([mx.ravel(), my.ravel(), mz.ravel()], axis=1)


def compute_center_grids_np(
    ind_space_size: Tuple[float, float, float],
    space_center: Tuple[float, float, float],
    ind_voxels: Tuple[int, int, int],
) -> np.ndarray:
    """2D coordinates of the three orthogonal planes (xy, xz, yz) of a
    person box, used by soft-argmax decoding: (3, P, 2), P = vox*vox,
    row-major over (axis0, axis1)."""
    vx, vy, vz = ind_voxels
    grid = compute_grid_np(ind_space_size, space_center, ind_voxels).reshape(
        vx, vy, vz, 3
    )
    plane_xy = grid[:, :, 0, :2].reshape(-1, 2)
    plane_xz = grid[:, 0, :, ::2].reshape(-1, 2)
    plane_yz = grid[0, :, :, 1:].reshape(-1, 2)
    return np.stack([plane_xy, plane_xz, plane_yz], axis=0)


def project_to_norm_coords(
    world_pts: torch.Tensor,
    cams: torch.Tensor,
    resize_transform: np.ndarray,
    ori_image_size: Tuple[int, int],
    image_size: Tuple[int, int],
    heatmap_size: Tuple[int, int],
) -> torch.Tensor:
    """World (N, 3) and packed cameras (..., 21) -> normalized heatmap
    sampling coords (..., N, 2) in [-1.1, 1.1].

    Pinhole + distortion projection, clamp to [-1, max(ori_wh)], the
    original->input resize affine (explicit f32 multiply-adds), the
    input->heatmap rescale and the align_corners=True normalization with
    the final [-1.1, 1.1] clamp, in the op order of the JAX package.

    Each division by a constant is a multiplication by its float32
    reciprocal (`reciprocal_f32`), which is what PyTorch's CUDA division
    by a scalar computes; written out, it rounds alike on every device and
    in the crop kernel, which repeats these steps op by op."""
    xy = project_points(world_pts, cams)
    xy = xy.clamp(-1.0, float(max(ori_image_size[0], ori_image_size[1])))
    t = [float(np.float32(v)) for v in np.asarray(resize_transform).ravel()]
    x = xy[..., 0] * t[0] + xy[..., 1] * t[1] + t[2]
    y = xy[..., 0] * t[3] + xy[..., 1] * t[4] + t[5]
    w, h = heatmap_size
    x = x * float(w) * reciprocal_f32(image_size[0])
    y = y * float(h) * reciprocal_f32(image_size[1])
    x = x * reciprocal_f32(w - 1) * 2.0 - 1.0
    y = y * reciprocal_f32(h - 1) * 2.0 - 1.0
    return torch.stack([x, y], dim=-1).clamp(-1.1, 1.1)


def reciprocal_f32(v: float) -> float:
    """1 / v rounded to float32."""
    return float(np.float32(1.0) / np.float32(v))


def norm_to_pixel(norm: torch.Tensor, heatmap_size: Tuple[int, int]) -> torch.Tensor:
    """Normalized align_corners=True coords (..., 2) -> heatmap pixels."""
    w, h = heatmap_size
    x = (norm[..., 0] + 1.0) * 0.5 * float(w - 1)
    y = (norm[..., 1] + 1.0) * 0.5 * float(h - 1)
    return torch.stack([x, y], dim=-1)
