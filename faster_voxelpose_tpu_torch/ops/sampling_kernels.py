"""The two sampling kernels of the heatmaps -> poses path, with their plain
PyTorch versions and launch counters.

Each wrapper takes its plain version for tensors on the CPU, and for CUDA
tensors launches its hand-written kernel (`csrc/sampling.cu`, built by
`ops/cuda_build.py`) or raises.  `LAUNCHES` counts kernel launches only.

sample_whole
    Replaces the JAX package's `sample_tiles` in cube mode
    (faster_voxelpose_tpu/ops/pallas_sampling.py:947, reached from
    project_whole_pallas, models/projection.py:340).  For each of the N
    voxels of the whole-space grid: the mean over V views of the bilinear
    samples of J heatmaps at precomputed pixel coords, clamped to [0, 1].
    Bound on an H100: bytes.  It must read the heatmaps (V*H*W*J*4 B) and
    the coords (V*N*2*4 B) once and write the cube (N*J*4 B): 22 MB at the
    Panoptic profile, about 6.6 us at 3.35 TB/s, against about 1.2 us for
    its ~80 MFLOP at the float32 rate.  Design: one thread per (voxel,
    joint), so a voxel's lanes read neighbouring joints of each corner
    and the cube store is coalesced; the 9.2 MB of heatmaps stay in the
    50 MB L2, so the 4 corners x V views of gathers hit L2, not memory.

sample_crop_planes
    Replaces `sample_tiles_fused(..., emit_planes=True, valid, mask)`
    (ops/pallas_sampling.py:1010, reached from
    project_individual_planes_pallas, models/projection.py:527).  For
    each valid proposal slot it projects each voxel of the 64^3 crop into
    every view in the kernel (the op order of `project_points` and
    `project_to_norm_coords`), samples, averages, clamps, applies the
    separable bbox mask and writes only the xy / xz / yz max-projections;
    no cube reaches device memory.  Bound on an H100: the operations of
    the live voxels (projection ~70 flops per voxel and view, plus ~8 per
    joint) against the bytes it must move (heatmaps in, three planes out,
    ~17 MB); which one wins depends on how much of each crop the bbox
    masks keep, so `chip_smoke.py` counts both from the run's own masks.
    The gathers are L2 traffic (13.1M samples x 4 corners x J x 4 B, about
    3 GB at K = 10), not device-memory traffic, which is why the real time
    sits far above the bound.  Design: one block per (slot, x slab); xy
    and xz reduce in shared memory, yz across blocks with atomicMax on the
    float bits (all values are >= 0); dead slots, masked slabs and masked
    voxels are skipped.  The projection rounds after every operation,
    as the plain version does: near a camera an FMA's missing rounding
    moves a sample by more than the 1e-5 tolerance.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from ..geometry.grids import norm_to_pixel, project_to_norm_coords, reciprocal_f32
from .sampling import sample_and_mean_views

LAUNCHES: Dict[str, int] = {"sample_whole": 0, "sample_crop_planes": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


@dataclass(frozen=True)
class CropProjection:
    """Constants of the per-voxel projection of the crop kernel: fine
    index i on an axis sits at origin + i * step (mm); then the rig, the
    resize affine and the heatmap frame, as in project_to_norm_coords."""

    origin: Tuple[float, float, float]
    step: Tuple[float, float, float]
    resize_transform: Tuple[float, ...]  # (6,) row-major 2x3
    ori_image_size: Tuple[int, int]
    image_size: Tuple[int, int]
    heatmap_size: Tuple[int, int]

    def consts(self) -> np.ndarray:
        """The 21 float32 values of the kernel's CropConsts struct."""
        w, h = self.heatmap_size
        iw, ih = self.image_size
        return np.asarray(
            [*self.origin, *self.step, *self.resize_transform,
             float(max(self.ori_image_size)),
             w, reciprocal_f32(iw), h, reciprocal_f32(ih),
             reciprocal_f32(w - 1), reciprocal_f32(h - 1), w - 1, h - 1],
            np.float32,
        )


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def sample_whole_plain(heatmaps: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    """heatmaps (V, H, W, J), pix (V, N, 2) -> (N, J) view mean, clamped."""
    return sample_and_mean_views(heatmaps, pix)


def crop_world_points(
    crop: CropProjection, tl: torch.Tensor, voxels: Tuple[int, int, int]
) -> torch.Tensor:
    """World coords (vx*vy*vz, 3) of one crop with fine-grid origin tl (3,)."""
    axes = []
    for a in range(3):
        idx = tl[a] + torch.arange(voxels[a], device=tl.device, dtype=tl.dtype)
        axes.append(crop.origin[a] + idx.float() * crop.step[a])
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)


def sample_crop_planes_plain(
    heatmaps: torch.Tensor,
    cams: torch.Tensor,
    centers_tl: torch.Tensor,
    mx: torch.Tensor,
    my: torch.Tensor,
    mz: torch.Tensor,
    valid: torch.Tensor,
    crop: CropProjection,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per slot: project the crop, sample every view, mean, clamp, mask
    and max-project.  One slot's cube is live at a time; invalid slots
    give zero planes.  Returns (K, vx, vy, J), (K, vx, vz, J), (K, vy, vz, J)."""
    K, vx, vy, vz = centers_tl.shape[0], mx.shape[1], my.shape[1], mz.shape[1]
    J = heatmaps.shape[-1]
    kw = dict(dtype=torch.float32, device=heatmaps.device)
    pxy, pxz, pyz = (torch.zeros((K, a, b, J), **kw)
                     for a, b in ((vx, vy), (vx, vz), (vy, vz)))
    for k in range(K):
        if not bool(valid[k]):
            continue
        pts = crop_world_points(crop, centers_tl[k], (vx, vy, vz))
        norm = project_to_norm_coords(
            pts, cams, np.asarray(crop.resize_transform).reshape(2, 3),
            crop.ori_image_size, crop.image_size, crop.heatmap_size,
        )
        pix = norm_to_pixel(norm, crop.heatmap_size)
        cube = sample_and_mean_views(heatmaps, pix).reshape(vx, vy, vz, J)
        m = (mx[k].bool()[:, None, None] & my[k].bool()[None, :, None]
             & mz[k].bool()[None, None, :])
        cube = cube * m[..., None].float()
        pxy[k], pxz[k], pyz[k] = cube.amax(2), cube.amax(1), cube.amax(0)
    return pxy, pxz, pyz


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    from .cuda_build import load

    lib = load("sampling")
    if not getattr(lib, "_fvp_typed", False):
        lib.fvp_sample_whole.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
        lib.fvp_sample_whole.restype = _I
        lib.fvp_sample_crop_planes.argtypes = (
            [_P] * 11 + [_I] * 8 + [_P]
        )
        lib.fvp_sample_crop_planes.restype = _I
        lib._fvp_typed = True
    return lib


def _on_cpu(*tensors: torch.Tensor) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"tensors must all lie on one CUDA device or the CPU, got {kinds}")
    return False


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def sample_whole(heatmaps: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    """heatmaps (V, H, W, J) f32, pix (V, N, 2) f32 -> (N, J) f32."""
    if _on_cpu(heatmaps, pix):
        return sample_whole_plain(heatmaps, pix)
    V, H, W, J = heatmaps.shape
    N = pix.shape[1]
    _check(heatmaps, "heatmaps", torch.float32, (V, H, W, J))
    _check(pix, "pix", torch.float32, (V, N, 2))
    if not 0 < J <= 32:
        raise ValueError(f"sample_whole takes 1..32 joints, got {J}")
    out = torch.empty((N, J), dtype=torch.float32, device=heatmaps.device)
    err = _lib().fvp_sample_whole(
        heatmaps.data_ptr(), pix.data_ptr(), out.data_ptr(), V, H, W, J, N,
        _stream(heatmaps.device),
    )
    _raise_on(err, "sample_whole")
    LAUNCHES["sample_whole"] += 1
    return out


def sample_crop_planes(
    heatmaps: torch.Tensor,
    cams: torch.Tensor,
    centers_tl: torch.Tensor,
    mx: torch.Tensor,
    my: torch.Tensor,
    mz: torch.Tensor,
    valid: torch.Tensor,
    crop: CropProjection,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """heatmaps (V, H, W, J) f32, cams (V, 21) f32, centers_tl (K, 3) int32,
    bbox axis masks mx (K, vx), my (K, vy), mz (K, vz) and valid (K,) as
    uint8 -> planes xy (K, vx, vy, J), xz (K, vx, vz, J), yz (K, vy, vz, J)."""
    args = (heatmaps, cams, centers_tl, mx, my, mz, valid)
    if _on_cpu(*args):
        return sample_crop_planes_plain(*args, crop)
    V, H, W, J = heatmaps.shape
    K, vx, vy, vz = centers_tl.shape[0], mx.shape[1], my.shape[1], mz.shape[1]
    _check(heatmaps, "heatmaps", torch.float32, (V, H, W, J))
    _check(cams, "cams", torch.float32, (V, 21))
    _check(centers_tl, "centers_tl", torch.int32, (K, 3))
    for t, name, n in ((mx, "mx", vx), (my, "my", vy), (mz, "mz", vz)):
        _check(t, name, torch.uint8, (K, n))
    _check(valid, "valid", torch.uint8, (K,))
    if not 0 < J <= 32:
        raise ValueError(f"sample_crop_planes takes 1..32 joints, got {J}")
    if 4 * (V * 21 + (vy + vz) * J) > 48 * 1024:
        raise ValueError("crop planes exceed the kernel's 48 KB of shared memory")
    kw = dict(dtype=torch.float32, device=heatmaps.device)
    pxy = torch.zeros((K, vx, vy, J), **kw)
    pxz = torch.zeros((K, vx, vz, J), **kw)
    pyz = torch.zeros((K, vy, vz, J), **kw)
    consts = crop.consts()
    err = _lib().fvp_sample_crop_planes(
        heatmaps.data_ptr(), cams.data_ptr(), centers_tl.data_ptr(),
        mx.data_ptr(), my.data_ptr(), mz.data_ptr(), valid.data_ptr(),
        consts.ctypes.data, pxy.data_ptr(), pxz.data_ptr(), pyz.data_ptr(),
        V, H, W, J, K, vx, vy, vz, _stream(heatmaps.device),
    )
    _raise_on(err, "sample_crop_planes")
    LAUNCHES["sample_crop_planes"] += 1
    return pxy, pxz, pyz
