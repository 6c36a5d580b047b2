"""The sampling kernels of the heatmaps -> poses path, with their plain
PyTorch versions and launch counters.

Each wrapper takes its plain version for tensors on the CPU, and for CUDA
tensors launches its hand-written kernel (`csrc/sampling.cu`, built by
`ops/cuda_build.py`) or raises.  `LAUNCHES` counts kernel launches only.

sample_whole (kernel row 1, coords mode)
    Replaces the JAX package's `sample_tiles` in cube mode
    (faster_voxelpose_tpu/ops/pallas_sampling.py:947, reached from
    project_whole_pallas, models/projection.py:340) as the TPU kernel
    computes it: for each of the N voxels of the whole-space grid, the
    mean over V views of the bilinear samples of J heatmaps at
    precomputed pixel coords, clamped to [0, 1].  Bound on an H100:
    bytes.  It must read the heatmaps (V*H*W*J*4 B) and the coords
    (V*N*2*4 B) once and write the cube (N*J*4 B): 22 MB at the Panoptic
    profile, about 6.6 us at 3.35 TB/s, against about 1.2 us for its ~80
    MFLOP at the float32 rate.  Design: one thread per (voxel, joint
    lane), lanes padded to a power of two, so a voxel's lanes read
    neighbouring joints of each corner and the cube store is coalesced;
    the 9.2 MB of heatmaps stay in the 50 MB L2, so the 4 corners x V
    views of gathers hit L2, not memory.  The served, trained and
    evaluated paths take the projected mode below; this mode is the
    gather baseline of `tools/probe_sampling.py`.

sample_whole_projected (kernel row 1, projected mode)
    Replaces `project_whole_batch_pallas`
    (faster_voxelpose_tpu/models/projection.py:384), which vmaps the same
    `sample_tiles` over the batch: the whole-space cubes (B, X, Y, Z, J)
    of a batch from heatmaps (B, V, H, W, J), cameras (B, V, 21) and the
    grid's three axis vectors, in one launch.  Bound on an H100: bytes,
    the heatmaps in and the cube out with no coords: 16.9 MB at the
    Panoptic profile and B = 1, about 5.0 us at 3.35 TB/s.  Design
    (`csrc/sampling.cu`, above whole_kernel): the grid is separable, so
    each block computes its sample's per-axis products once and each
    thread projects one voxel into every view, bit for bit the pixel of
    `whole_pixels`; the coords tensor and the ~87 tensor ops per sample
    that built it are gone.  Blocks of 256 voxels, consecutive in the
    cube's order, spread their 256 J (voxel, joint) pairs flat over 256
    threads, so every lane works at any J, and write one contiguous run.
    The corners are gathered from L2: a design that staged each tile's
    footprint in shared memory by bulk asynchronous copies read 1.6-1.9x
    slower and was dropped (`csrc/sampling.cu`, above whole_kernel).

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
    The gathers are L2 traffic (3.5M live (voxel, view) samples x 4
    corners x J x 4 B, about 0.85 GB at K = 10), not device-memory
    traffic, which is why the real time sits far above the bound.
    Design (`csrc/sampling.cu`, above crop_kernel): one block of 256
    threads per (slot, 4 x 4 x 32 tile), so the threads at work follow the
    live voxels; dead slots and tiles the masks empty return at once.  A
    warp walks its tile's (x, y) columns; in each it compacts the voxels
    the masks keep, and each of their lanes projects its voxel into every
    view once: the camera-frame coordinates are sums of per-axis products
    that the block computes once, added in `project_points`' order, so
    the pixel is bit for bit the unfactored one; then the divide,
    distortion and affine, rounding after every operation as the plain
    version does (near a camera an FMA's missing rounding moves a sample
    by more than the 1e-5 tolerance).  The lane leaves the four corner
    taps in shared memory, and the voxel's joint lanes issue all views'
    corner loads before they sum any.  The planes reduce on chip: xy in
    registers over a column, xz and yz in shared memory over the tile,
    then one atomicMax on the float bits (all values are >= 0) per
    (tile, cell, joint) holding a value: at most 5,967,480 global atomics
    at the Panoptic case of `chip_smoke.py`, against at most one per live
    (voxel, joint), 10,520,280, before (upper bounds that `chip_smoke.py`
    computes from the masks).  Any uint8 masks work, intervals or not.

sample_crop_planes_coords
    Replaces `sample_tiles(..., emit_planes=True, valid, mask)` on
    precomputed coords (ops/pallas_sampling.py:947, reached from
    project_individual_planes_pallas, models/projection.py:485-505 and
    :532-535, when PALLAS_FUSED_COORDS is false, a tile dim is not a
    power of two, or the heatmap fits one window).  sample_crop_planes
    with the pixels read from a (K, V, N, 2) coords tensor that PyTorch
    computed (`crop_pixels`) instead of projected in the kernel.  Bound
    on an H100: the coords of the live voxels (8 B per voxel and view)
    and the planes against the same gathers' operations, counted by
    `chip_smoke.py` from the masks.  Design: the same device code as
    sample_crop_planes (one template), the taps made from the coords;
    dead slots, masked tiles and masked voxels read no coords.

sample_crop_cube
    Replaces the masked cube mode of `sample_tiles` / `sample_tiles_fused`
    (ops/pallas_sampling.py:947 / :1010), which the JAX package takes when
    a tile dim is not a power of two or a tile's voxel count is not a
    multiple of 128 (models/projection.py:547-571): the bbox-masked crop
    cube (K, vx, vy, vz, J), from in-kernel projection or from coords,
    whose planes the caller takes by max-reduction.  Bound on an H100:
    bytes; it must write the whole cube (157 MB at K = 10, about 47 us),
    plus the coords when it reads them.  Design: the same template, with
    every cube element written once (zeros for dead slots, masked tiles,
    columns and voxels), a column's z run contiguous, so the output needs
    no zero fill.

Every kernel here is forward only: no gradient reaches the samplers in
training (the heatmaps are data, the proposals are detached), and each
wrapper raises on an input that requires grad rather than detach it.

The wrappers launch the production build of `csrc/sampling.cu`; inside
`with kernel_variant(defines):` they launch a variant built with those
`-D` defines (the block shapes of the source's `#ifndef` guards) from a
library of its own, as the block-shape sweeps (`tools/sweep_planes.py`,
`tools/sweep_whole.py`) do.
"""

from __future__ import annotations

import contextlib
import ctypes
from dataclasses import dataclass
from typing import Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..geometry.grids import norm_to_pixel, project_to_norm_coords, reciprocal_f32
from .sampling import sample_and_mean_views

LAUNCHES: Dict[str, int] = {
    "sample_whole": 0,
    "sample_whole_projected": 0,
    "sample_crop_planes": 0,
    "sample_crop_planes_coords": 0,
    "sample_crop_cube": 0,
    # the tuning kernels of ops/window_kernels.py
    "window_sample": 0,
    "mma_window": 0,
    # WeightNet's front, ops/weightnet_kernels.py
    "weightnet_front": 0,
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def add_launches(counts: Mapping[str, int]) -> None:
    """Add `counts` to the launch counts: the kernels that a replay of a
    CUDA graph launches, which no wrapper sees (`engine/service.py`
    records them at capture, where the wrappers ran but launched
    nothing, and adds them on each replay)."""
    for name, n in counts.items():
        LAUNCHES[name] += n


@dataclass(frozen=True)
class CropProjection:
    """Constants of the per-voxel projection of the projecting kernels:
    fine index i on an axis of a crop sits at origin + i * step (mm; the
    whole-space sampler takes its grid from the axes it is given and
    ignores both); then the rig, the resize affine and the heatmap frame,
    as in project_to_norm_coords."""

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


def grid_pixels(proj: CropProjection, pts: torch.Tensor, cams: torch.Tensor) -> torch.Tensor:
    """World points (..., N, 3) and cams (..., 21) -> heatmap pixel coords
    (..., N, 2), as the JAX package computes the coords of its sampling
    kernel (models/projection.py:371-378, :487-505)."""
    norm = project_to_norm_coords(
        pts, cams, np.asarray(proj.resize_transform).reshape(2, 3), proj.ori_image_size,
        proj.image_size, proj.heatmap_size,
    )
    return norm_to_pixel(norm, proj.heatmap_size).contiguous()


def axes_grid(axes: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """The (X*Y*Z, 3) grid of three axis vectors, x-major, as
    compute_grid_np lays it out."""
    gx, gy, gz = axes
    mesh = torch.meshgrid(gx, gy, gz, indexing="ij")
    return torch.stack([m.reshape(-1) for m in mesh], dim=1)


def sample_whole_projected_plain(
    heatmaps: torch.Tensor, cams: torch.Tensor,
    axes: Tuple[torch.Tensor, torch.Tensor, torch.Tensor], proj: CropProjection,
) -> torch.Tensor:
    """heatmaps (B, V, H, W, J), cams (B, V, 21), axes (X,), (Y,), (Z,) ->
    (B, X, Y, Z, J): per sample the grid's pixels in every view, then the
    view mean of their bilinear samples, clamped."""
    grid = axes_grid(axes)
    shape = tuple(len(a) for a in axes) + (heatmaps.shape[-1],)
    return torch.stack([
        sample_whole_plain(hm, grid_pixels(proj, grid, c)).reshape(shape)
        for hm, c in zip(heatmaps, cams)
    ])


def crop_world_points(
    crop: CropProjection, tl: torch.Tensor, voxels: Tuple[int, int, int]
) -> torch.Tensor:
    """World coords (..., vx*vy*vz, 3) of crops with fine-grid origins
    tl (..., 3), voxels in (x, y, z) order."""
    lead = tuple(tl.shape[:-1])
    axes = []
    for a in range(3):
        idx = tl[..., a, None] + torch.arange(voxels[a], device=tl.device, dtype=tl.dtype)
        axes.append(crop.origin[a] + idx.float() * crop.step[a])  # (..., v_a)
    full = lead + tuple(voxels)
    gx = axes[0][..., :, None, None].expand(full)
    gy = axes[1][..., None, :, None].expand(full)
    gz = axes[2][..., None, None, :].expand(full)
    return torch.stack([gx, gy, gz], dim=-1).reshape(lead + (-1, 3))


def crop_pixels(
    crop: CropProjection, cams: torch.Tensor, centers_tl: torch.Tensor,
    voxels: Tuple[int, int, int],
) -> torch.Tensor:
    """Heatmap pixel coords (K, V, vx*vy*vz, 2) of every crop voxel in
    every view, as the JAX package's `person_coords` computes them
    (models/projection.py:487-505): one tensor for all K slots."""
    pts = crop_world_points(crop, centers_tl, voxels)  # (K, N, 3)
    return grid_pixels(crop, pts[:, None], cams)


def sample_crop_planes_plain(
    heatmaps: torch.Tensor,
    cams: torch.Tensor,
    centers_tl: torch.Tensor,
    mx: torch.Tensor,
    my: torch.Tensor,
    mz: torch.Tensor,
    valid: torch.Tensor,
    crop: CropProjection,
    *,
    cube: bool = False,
):
    """The crop sampler with each slot's pixels projected from cams,
    centers_tl and crop: the plain version of sample_crop_planes, and
    with `cube` of sample_crop_cube's projecting mode."""
    voxels = (mx.shape[1], my.shape[1], mz.shape[1])

    def slot_pixels(k: int) -> torch.Tensor:
        return grid_pixels(crop, crop_world_points(crop, centers_tl[k], voxels), cams)

    return _crop_plain(heatmaps, slot_pixels, mx, my, mz, valid, cube=cube)


def sample_crop_coords_plain(
    heatmaps: torch.Tensor,
    pix: torch.Tensor,
    mx: torch.Tensor,
    my: torch.Tensor,
    mz: torch.Tensor,
    valid: torch.Tensor,
    *,
    cube: bool = False,
):
    """The crop sampler with the pixels read from pix (K, V, N, 2): the
    plain version of sample_crop_planes_coords, and with `cube` of
    sample_crop_cube's coords mode."""
    return _crop_plain(heatmaps, lambda k: pix[k], mx, my, mz, valid, cube=cube)


def _crop_plain(heatmaps, slot_pixels, mx, my, mz, valid, *, cube):
    """Per valid slot: its pixels (V, N, 2) from slot_pixels(k), sample
    every view, mean, clamp, mask; then max-project, or with `cube` keep
    the masked cube.  One slot's cube is live at a time unless `cube`;
    invalid slots give zeros.  Returns (K, vx, vy, J), (K, vx, vz, J),
    (K, vy, vz, J), or the cube (K, vx, vy, vz, J)."""
    K, vx, vy, vz = mx.shape[0], mx.shape[1], my.shape[1], mz.shape[1]
    J = heatmaps.shape[-1]
    kw = dict(dtype=torch.float32, device=heatmaps.device)
    if cube:
        out = torch.zeros((K, vx, vy, vz, J), **kw)
    else:
        pxy, pxz, pyz = (torch.zeros((K, a, b, J), **kw)
                         for a, b in ((vx, vy), (vx, vz), (vy, vz)))
    for k in range(K):
        if not bool(valid[k]):
            continue
        c = sample_and_mean_views(heatmaps, slot_pixels(k)).reshape(vx, vy, vz, J)
        m = (mx[k].bool()[:, None, None] & my[k].bool()[None, :, None]
             & mz[k].bool()[None, None, :])
        c = c * m[..., None].float()
        if cube:
            out[k] = c
        else:
            pxy[k], pxz[k], pyz[k] = c.amax(2), c.amax(1), c.amax(0)
    return out if cube else (pxy, pxz, pyz)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


# the -D defines of the variant the wrappers launch (`kernel_variant`)
_VARIANT: Tuple[str, ...] = ()


@contextlib.contextmanager
def kernel_variant(defines: Sequence[str]) -> Iterator[None]:
    """Within the block, the wrappers and the launch-geometry readers use
    csrc/sampling.cu built with `defines` ("FVP_CROP_TX=8", ...; none is
    the production build)."""
    global _VARIANT
    before, _VARIANT = _VARIANT, tuple(defines)
    try:
        yield
    finally:
        _VARIANT = before


def _lib():
    from .cuda_build import load

    lib = load("sampling", _VARIANT)
    if not getattr(lib, "_fvp_typed", False):
        lib.fvp_sample_whole.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
        lib.fvp_sample_whole.restype = _I
        lib.fvp_sample_crop.argtypes = [_P] * 13 + [_I] * 10 + [_P]
        lib.fvp_sample_crop.restype = _I
        lib.fvp_crop_launch_geometry.argtypes = [_I] * 8 + [_P]
        lib.fvp_crop_launch_geometry.restype = _I
        lib.fvp_sample_whole_projected.argtypes = [_P] * 7 + [_I] * 8 + [_P]
        lib.fvp_sample_whole_projected.restype = _I
        lib.fvp_whole_launch_geometry.argtypes = [_I] * 5 + [_P]
        lib.fvp_whole_launch_geometry.restype = _I
        lib._fvp_typed = True
    return lib


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors (plain version), False for tensors on one CUDA
    device (kernel); raises on a mix and on an input that requires grad,
    since the kernels have no backward."""
    if any(t.requires_grad for t in tensors):
        raise ValueError("the sampling kernels are forward only: an input requires grad")
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


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


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


# fvp_sample_crop's and fvp_sample_whole_projected's return when the
# shapes need more shared memory per block than the device has
_ERR_SHARED_MEMORY = -1


def whole_launch_geometry(V: int, grid: Tuple[int, int, int], B: int) -> Dict[str, object]:
    """The launch of sample_whole_projected for these shapes, as the
    kernel's source computes it: grid (tiles, B), threads per block,
    dynamic shared memory and the most a block of the current CUDA device
    may have, in bytes, and voxels per block.  For reports and tests; the
    launch itself does not call it."""
    out = (ctypes.c_longlong * 6)()
    err = _lib().fvp_whole_launch_geometry(V, *grid, B, out)
    _raise_on(err, "whole_launch_geometry")
    return dict(grid=(out[0], out[1]), threads=out[2], smem=out[3], smem_max=out[4],
                voxels=out[5])


def sample_whole_projected(
    heatmaps: torch.Tensor, cams: torch.Tensor,
    axes: Tuple[torch.Tensor, torch.Tensor, torch.Tensor], proj: CropProjection,
) -> torch.Tensor:
    """heatmaps (B, V, H, W, J) f32, cams (B, V, 21) f32, the grid's axes
    (X,), (Y,), (Z,) f32 and the projection constants -> the whole-space
    cubes (B, X, Y, Z, J) f32."""
    gx, gy, gz = axes
    if _on_cpu(heatmaps, cams, gx, gy, gz):
        return sample_whole_projected_plain(heatmaps, cams, axes, proj)
    name = "sample_whole_projected"
    if heatmaps.dim() != 5:
        raise ValueError(f"{name}: heatmaps of shape {tuple(heatmaps.shape)}, expected "
                         "(B, V, H, W, J)")
    B, V, H, W, J = heatmaps.shape
    X, Y, Z = len(gx), len(gy), len(gz)
    _check(heatmaps, "heatmaps", torch.float32, (B, V, H, W, J))
    _check(cams, "cams", torch.float32, (B, V, 21))
    for t, tname, n in ((gx, "gx", X), (gy, "gy", Y), (gz, "gz", Z)):
        _check(t, tname, torch.float32, (n,))
    if not 0 < J <= 32:
        raise ValueError(f"{name} takes 1..32 joints, got {J}")
    if not 0 < V <= 8:
        raise ValueError(f"{name} takes 1..8 views, got {V}")
    if (W, H) != tuple(proj.heatmap_size):
        raise ValueError(f"{name}: heatmaps of {W}x{H}, the projection's are "
                         f"{proj.heatmap_size[0]}x{proj.heatmap_size[1]}")
    if B > 65535:
        raise ValueError(f"{name} takes at most 65535 samples, got {B}")
    out = torch.empty((B, X, Y, Z, J), dtype=torch.float32, device=heatmaps.device)
    consts = proj.consts()
    err = _lib().fvp_sample_whole_projected(
        heatmaps.data_ptr(), cams.data_ptr(), gx.data_ptr(), gy.data_ptr(), gz.data_ptr(),
        consts.ctypes.data, out.data_ptr(), B, V, H, W, J, X, Y, Z,
        _stream(heatmaps.device),
    )
    if err == _ERR_SHARED_MEMORY:
        raise ValueError(f"{name}: {V} views and a {X}x{Y}x{Z} grid need more shared memory "
                         "per block than the device has")
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def crop_launch_geometry(V: int, J: int, K: int, voxels: Tuple[int, int, int], *,
                         project: bool, cube: bool) -> Dict[str, object]:
    """The crop sampler's launch for these shapes, as the kernel's source
    computes it: grid (tiles, K), threads per block, dynamic shared
    memory and the most a block of the current CUDA device may have, in
    bytes, and the block tile (x, y, z).  For reports and tests; the
    launch itself does not call it."""
    out = (ctypes.c_longlong * 8)()
    err = _lib().fvp_crop_launch_geometry(V, J, K, *voxels, int(not project), int(cube), out)
    _raise_on(err, "crop_launch_geometry")
    return dict(grid=(out[0], out[1]), threads=out[2], smem=out[3], smem_max=out[4],
                tile=tuple(out[5:8]))


def _launch_crop(name, heatmaps, mx, my, mz, valid, *, cams=None, centers_tl=None,
                 crop=None, pix=None, cube=False):
    """Check the inputs of one crop-sampler mode, allocate its outputs and
    launch fvp_sample_crop; pixels come from pix when given, else from
    cams, centers_tl and crop."""
    V, H, W, J = heatmaps.shape
    K, vx, vy, vz = mx.shape[0], mx.shape[1], my.shape[1], mz.shape[1]
    _check(heatmaps, "heatmaps", torch.float32, (V, H, W, J))
    for t, tname, n in ((mx, "mx", vx), (my, "my", vy), (mz, "mz", vz)):
        _check(t, tname, torch.uint8, (K, n))
    _check(valid, "valid", torch.uint8, (K,))
    if pix is None:
        _check(cams, "cams", torch.float32, (V, 21))
        _check(centers_tl, "centers_tl", torch.int32, (K, 3))
        consts = crop.consts()
    else:
        _check(pix, "pix", torch.float32, (K, V, vx * vy * vz, 2))
        consts = np.zeros(21, np.float32)
    if not 0 < J <= 32:
        raise ValueError(f"{name} takes 1..32 joints, got {J}")
    if K > 65535:
        raise ValueError(f"{name} takes at most 65535 slots, got {K}")
    kw = dict(dtype=torch.float32, device=heatmaps.device)
    if cube:
        out = (torch.empty((K, vx, vy, vz, J), **kw),)
        planes = (None, None, None)
    else:
        out = planes = tuple(torch.zeros((K, a, b, J), **kw)
                             for a, b in ((vx, vy), (vx, vz), (vy, vz)))
    err = _lib().fvp_sample_crop(
        heatmaps.data_ptr(), _ptr(cams), _ptr(centers_tl), _ptr(pix),
        mx.data_ptr(), my.data_ptr(), mz.data_ptr(), valid.data_ptr(),
        consts.ctypes.data, *(_ptr(p) for p in planes), _ptr(out[0]) if cube else None,
        V, H, W, J, K, vx, vy, vz, int(pix is not None), int(cube),
        _stream(heatmaps.device),
    )
    if err == _ERR_SHARED_MEMORY:
        raise ValueError(f"{name}: {V} views and {J} joints need more shared memory per "
                         "block than the device has")
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out[0] if cube else out


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
    return _launch_crop("sample_crop_planes", heatmaps, mx, my, mz, valid,
                        cams=cams, centers_tl=centers_tl, crop=crop)


def sample_crop_planes_coords(
    heatmaps: torch.Tensor,
    pix: torch.Tensor,
    mx: torch.Tensor,
    my: torch.Tensor,
    mz: torch.Tensor,
    valid: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """sample_crop_planes with the pixels given: pix (K, V, vx*vy*vz, 2)
    f32 heatmap pixel coords, voxels in (x, y, z) order."""
    if _on_cpu(heatmaps, pix, mx, my, mz, valid):
        return sample_crop_coords_plain(heatmaps, pix, mx, my, mz, valid)
    return _launch_crop("sample_crop_planes_coords", heatmaps, mx, my, mz, valid, pix=pix)


def sample_crop_cube(
    heatmaps: torch.Tensor,
    mx: torch.Tensor,
    my: torch.Tensor,
    mz: torch.Tensor,
    valid: torch.Tensor,
    *,
    cams: Optional[torch.Tensor] = None,
    centers_tl: Optional[torch.Tensor] = None,
    crop: Optional[CropProjection] = None,
    pix: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The bbox-masked crop cubes (K, vx, vy, vz, J) f32, zero for invalid
    slots; pixels from pix (K, V, N, 2) when given, else projected from
    cams (V, 21), centers_tl (K, 3) int32 and crop."""
    if (pix is None) == (cams is None):
        raise ValueError("sample_crop_cube takes either pix or cams, centers_tl and crop")
    src = (pix,) if pix is not None else (cams, centers_tl)
    if _on_cpu(heatmaps, mx, my, mz, valid, *src):
        if pix is not None:
            return sample_crop_coords_plain(heatmaps, pix, mx, my, mz, valid, cube=True)
        return sample_crop_planes_plain(heatmaps, cams, centers_tl, mx, my, mz, valid, crop,
                                        cube=True)
    return _launch_crop("sample_crop_cube", heatmaps, mx, my, mz, valid, cams=cams,
                        centers_tl=centers_tl, crop=crop, pix=pix, cube=True)
