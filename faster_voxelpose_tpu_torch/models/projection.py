"""Multi-view heatmap back-projection into voxel feature volumes
(counterpart of `faster_voxelpose_tpu/models/projection.py`).

Whole-space stage: the `sample_whole_projected` kernel projects the static
world grid into every view and samples it into the (B, X, Y, Z, J) cubes
of a batch in one launch (`project_whole_batch`); `project_whole` is the
same stage of one sample on coords computed by PyTorch (`sample_whole`).
Per-person stage: each proposal's 64^3 crop is rebuilt from its
integer origin on the virtual fine grid, projected, sampled, masked and
max-projected onto three planes.  The config keys that choose how the
JAX package's crop kernel computes that (`resolve_crop_route`) choose
one of four routes here: by default the `sample_crop_planes` kernel
projects in the kernel and stores no crop cube; the other routes read
coords computed by PyTorch and/or store the masked cube and take its
planes by max-reduction, as the JAX package does on those settings.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..geometry.grids import compute_center_grids_np, compute_grid_np
from ..geometry.transforms import get_resize_transform
from ..ops.sampling_kernels import (
    CropProjection,
    crop_pixels,
    grid_pixels,
    sample_crop_cube,
    sample_crop_planes,
    sample_crop_planes_coords,
    sample_whole,
    sample_whole_projected,
)

CropRoute = Tuple[str, str]  # (coords source, output)
DEFAULT_CROP_ROUTE: CropRoute = ("project", "planes")


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


def whole_projection(geom: ProjectionGeometry) -> CropProjection:
    """Kernel constants of the whole-space projection: the rig's frame and
    the heatmap's; the grid comes from `whole_axes`, so origin and step
    are unused."""
    return CropProjection(
        origin=(0.0, 0.0, 0.0),
        step=(0.0, 0.0, 0.0),
        resize_transform=tuple(float(v) for v in
                               np.asarray(geom.resize_transform, np.float32).ravel()),
        ori_image_size=tuple(geom.ori_image_size),
        image_size=tuple(geom.image_size),
        heatmap_size=tuple(geom.heatmap_size),
    )


def crop_projection(geom: ProjectionGeometry) -> CropProjection:
    """Kernel constants of the crop projection: fine index i lies at
    (center - S/2) + i * S/(F-1), all in float32 as the JAX package
    computes them; the frames as for the whole space."""
    space = np.asarray(geom.space_size, np.float32)
    center = np.asarray(geom.space_center, np.float32)
    fine = np.asarray(geom.fine_voxels_per_axis, np.float32)
    step = space / (fine - np.float32(1.0))
    origin = center - space / np.float32(2.0)
    return dataclasses.replace(whole_projection(geom), origin=tuple(float(v) for v in origin),
                               step=tuple(float(v) for v in step))


def whole_axes(geom: ProjectionGeometry) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The whole grid's axis vectors (X,), (Y,), (Z,) as float32, read from
    `geom.whole_grid` (a meshgrid of three linspaces), so that they rebuild
    it bit for bit."""
    grid = geom.whole_grid.reshape(*geom.voxels_per_axis, 3)
    return grid[:, 0, 0, 0].copy(), grid[0, :, 0, 1].copy(), grid[0, 0, :, 2].copy()


def whole_pixels(
    geom: ProjectionGeometry, grid: torch.Tensor, cams: torch.Tensor
) -> torch.Tensor:
    """World grid (N, 3), cams (V, 21) -> heatmap pixel coords (V, N, 2),
    as project_whole_pallas computes them (models/projection.py:371-378
    of the JAX package)."""
    return grid_pixels(whole_projection(geom), grid, cams)


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


def project_whole_batch(
    geom: ProjectionGeometry,
    heatmaps: torch.Tensor,  # (B, V, H, W, J)
    cams: torch.Tensor,  # (B, V, 21)
    axes: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],  # whole_axes on the device
) -> torch.Tensor:
    """The whole-space cubes (B, X, Y, Z, J) of a batch, the grid projected
    in the kernel, one launch (project_whole_batch_pallas,
    models/projection.py:384 of the JAX package)."""
    return sample_whole_projected(heatmaps.contiguous(), cams.contiguous(), axes,
                                  whole_projection(geom))


class CropConstants(NamedTuple):
    """The crop stage's constants as tensors, for a module to hold as
    buffers on its device (`JointLocalizationNet`): a forward then builds
    no tensor from host data, which a CUDA graph could not capture and
    which would cost the eager forward a host->device copy each."""

    fine_scale: torch.Tensor  # (3,) f32, crop-origin affine
    fine_bias: torch.Tensor  # (3,) f32
    fine_voxels: torch.Tensor  # (3,) f32, the virtual fine grid's voxels per axis
    space_size: torch.Tensor  # (3,) f32, mm
    ind_space_size: torch.Tensor  # (3,) f32, mm
    ind_voxels_i32: torch.Tensor  # (3,) int32, a crop's voxels per axis
    fine_voxels_i32: torch.Tensor  # (3,) int32


def crop_constants(geom: ProjectionGeometry, device=None) -> CropConstants:
    """The CropConstants of `geom` on `device` (default the CPU)."""
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return CropConstants(
        fine_scale=torch.as_tensor(geom.fine_scale, device=device),
        fine_bias=torch.as_tensor(geom.fine_bias, device=device),
        fine_voxels=torch.tensor(geom.fine_voxels_per_axis, **f32),
        space_size=torch.tensor(geom.space_size, **f32),
        ind_space_size=torch.tensor(geom.ind_space_size, **f32),
        ind_voxels_i32=torch.tensor(geom.ind_voxels_per_axis, **i32),
        fine_voxels_i32=torch.tensor(geom.fine_voxels_per_axis, **i32),
    )


def compute_crop_origin(
    geom: ProjectionGeometry, centers_mm: torch.Tensor, consts: Optional[CropConstants] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integer crop origin on the virtual fine grid (round half to even,
    as jnp.round) and the crop's mm offset (reference
    project_individual.py:110-111).  `consts` on the centres' device,
    else built from `geom` for this call."""
    c = consts if consts is not None else crop_constants(geom, centers_mm.device)
    tl = torch.round(centers_mm.float() * c.fine_scale + c.fine_bias).to(torch.int32)
    space = c.space_size
    offset = tl.float() / (c.fine_voxels - 1) * space - space / 2.0 + c.ind_space_size / 2.0
    return tl, offset


def crop_axis_masks(
    geom: ProjectionGeometry, centers_tl: torch.Tensor, bbox_sizes: torch.Tensor,
    consts: Optional[CropConstants] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-axis factors mx (K, vx), my (K, vy), mz (K, vz) of the separable
    crop mask that zeroes voxels outside the predicted bbox or the capture
    volume (reference project_individual.py:114-121).  `consts` as for
    `compute_crop_origin`."""
    dev = centers_tl.device
    c = consts if consts is not None else crop_constants(geom, dev)
    vox = c.ind_voxels_i32
    margin_xy = ((1.0 - bbox_sizes.float()) / 2.0 * (vox[:2].float() - 1)).to(torch.int32)
    margin = torch.cat(
        [margin_xy.clamp(min=0), torch.zeros_like(margin_xy[:, :1])], dim=1
    )
    start = (centers_tl + margin).clamp(min=0)
    end = torch.minimum(centers_tl + vox - margin, c.fine_voxels_i32)
    masks = []
    for a in range(3):
        f = centers_tl[:, a:a + 1] + torch.arange(
            geom.ind_voxels_per_axis[a], dtype=torch.int32, device=dev
        )
        masks.append((f >= start[:, a:a + 1]) & (f < end[:, a:a + 1]))
    return masks[0], masks[1], masks[2]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def resolve_crop_route(cfg: Config) -> CropRoute:
    """How the crop stage runs under the config's sampling keys:
    (coords source, output) with source "project" (pixels projected in
    the kernel) or "coords" (pixels computed by PyTorch, read by the
    kernel) and output "planes" (max planes in the kernel) or "cube" (the
    masked cube, planes by max-reduction).

    The rules copy the JAX package's `resolve_sampling_spec`
    (models/faster_voxelpose.py:55-82) and the planes test of
    `project_individual_planes_pallas` (models/projection.py:518-519):
    coords when PALLAS_FUSED_COORDS is false, a tile dim is not a power of
    two, or the heatmap fits one kernel window; cube when a tile dim is
    not a power of two or a tile's voxel count is not a multiple of 128.

    Where the JAX package takes its quad path instead of the kernel
    (SAMPLING_BACKEND "quad", a tile that does not divide the crop, a
    heatmap group past the kernel's memory), the port keeps the default
    route: the quad path computes the same function.  The JAX package
    also takes the quad path on any backend but a TPU; the port answers
    as it would on a TPU, so a config selects the same mode on both.  On
    the card every route runs a kernel; the plain versions run only for
    tensors on the CPU.

    The window arithmetic (PALLAS_WINDOW, rows rounded to 8 or 16 by
    PALLAS_EXACT, the 12 MiB fit and the bf16 item size) is the TPU
    kernel's VMEM tiling, copied only so that a config picks the same mode
    here: it describes nothing of the card.  All four modes give the same
    planes on the card, and the default route serves fastest of them
    (`chip_smoke.py`'s route phase, PERF.md)."""
    n = cfg.NETWORK
    if n.SAMPLING_BACKEND == "quad":
        return DEFAULT_CROP_ROUTE
    tile = tuple(int(t) for t in n.PALLAS_TILE)
    exact = bool(n.PALLAS_EXACT)
    sub = 8 if exact else 16  # row granularity of the packed heatmaps
    W, H = cfg.DATASET.HEATMAP_SIZE
    hp, wp = _round_up(H, sub), _round_up(W, 8)
    itemsize = 4 if exact else 2
    fits = (
        cfg.DATASET.CAMERA_NUM * hp * wp * 16 * itemsize <= 12 * 2**20
        and all(v % t == 0 for v, t in zip(cfg.INDIVIDUAL_SPEC.VOXELS_PER_AXIS, tile))
    )
    if not fits:
        if n.SAMPLING_BACKEND == "pallas":
            raise ValueError(
                "SAMPLING_BACKEND 'pallas' requested but the profile does not fit "
                f"the kernel (heatmap {W}x{H}, tile {tile})"
            )
        return DEFAULT_CROP_ROUTE
    xw = min(int(n.PALLAS_WINDOW[0]), wp)
    yw = min(_round_up(int(n.PALLAS_WINDOW[1]), sub), hp)
    one_window = -(-wp // xw) == 1 and -(-hp // yw) == 1
    pow2 = not any(d & (d - 1) for d in tile)
    source = "project" if n.PALLAS_FUSED_COORDS and pow2 and not one_window else "coords"
    samples = tile[0] * tile[1] * tile[2]
    output = "planes" if pow2 and samples % 128 == 0 else "cube"
    return source, output


def project_individual_planes(
    geom: ProjectionGeometry,
    heatmaps: torch.Tensor,  # (V, H, W, J)
    cams: torch.Tensor,  # (V, 21)
    centers_tl: torch.Tensor,  # (K, 3) int32
    bbox_sizes: torch.Tensor,  # (K, 2)
    valid: torch.Tensor,  # (K,) bool; invalid slots give zero planes
    route: CropRoute = DEFAULT_CROP_ROUTE,
    consts: Optional[CropConstants] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-person plane projections (xy (K,X,Y,J), xz (K,X,Z,J),
    yz (K,Y,Z,J)) of the bbox-masked crop cubes
    (joint_localization_net.py:80-81), by the crop route of
    `resolve_crop_route`; `consts` as for `compute_crop_origin`."""
    source, output = route
    mx, my, mz = (m.to(torch.uint8)
                  for m in crop_axis_masks(geom, centers_tl, bbox_sizes, consts))
    heatmaps, valid = heatmaps.contiguous(), valid.to(torch.uint8).contiguous()
    cams, tl = cams.float().contiguous(), centers_tl.to(torch.int32).contiguous()
    crop = crop_projection(geom)
    if source == "coords":
        pix = crop_pixels(crop, cams, tl, geom.ind_voxels_per_axis)
        if output == "planes":
            return sample_crop_planes_coords(heatmaps, pix, mx, my, mz, valid)
        cube = sample_crop_cube(heatmaps, mx, my, mz, valid, pix=pix)
    elif output == "planes":
        return sample_crop_planes(heatmaps, cams, tl, mx, my, mz, valid, crop)
    else:
        cube = sample_crop_cube(heatmaps, mx, my, mz, valid, cams=cams, centers_tl=tl,
                                crop=crop)
    # (K, X, Y, Z, J) -> max over z, y, x (models/projection.py:560-570)
    return cube.amax(3), cube.amax(2), cube.amax(1)
