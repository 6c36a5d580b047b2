"""MvP's projective attention as one kernel, with its plain PyTorch
version; launches are counted in `sampling_kernels.LAUNCHES` under
'projattn'.

The wrapper takes its plain version for tensors on the CPU, and for CUDA
tensors launches its hand-written kernel (`csrc/projattn.cu`, built by
`ops/cuda_build.py`) or raises.

projective_attention
    Step 2 of an MvP decoder layer (`models/mvp.py`) short of its output
    projection: for every query q, view v and head m, the query's
    reference point y (normalised in the capture space) taken to world
    mm, projected into view v (`ProjAttnGeometry`: the port's projection
    to network-input pixels, then divided by the input's size to u), and
    L x P taps per head at u + offset / (W_l, H_l) on the L value maps
    (B, V, H_l, W_l, M * Dh), each sampled as `F.grid_sample(
    align_corners=False, padding_mode='zeros')` samples, weighted by the
    softmax of the head's L * P logits and summed: (B, V, Q, M * Dh).  It
    replaces no Pallas kernel: the JAX package has no MvP.  On the card it
    takes the place of one `grid_sample` per view and level and the
    softmax, weighting and sums around them (90 launches a request at
    MvP's Panoptic widths in plain PyTorch, 6 here).  Bound on an H100:
    bytes, 4 corners x Dh channels x 2 B of each tap read once, 72,000
    taps a launch at Panoptic (150 queries x 5 views x 8 heads x 3 levels
    x 4 points), 18.4 MB of taps and 19.0 MB with the offsets and logits
    in and the output out, about 5.7 us at 3.35 TB/s
    (`benchmark/counts/mvp.py`).  Design (`csrc/projattn.cu`): one block
    per (query, view), one warp per head, one lane per channel; the
    projection once per block, in the device code the samplers use
    (`csrc/projection.cuh`); the softmax and the taps' offsets by warp
    shuffles; sums in float32, the output rounded to bf16 once.

The kernel is forward only and raises on an input that requires grad.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..geometry.cameras import project_points
from .sampling_kernels import LAUNCHES, _raise_on, _stream

MAX_LEVELS = 4
MAX_HEAD_DIM = 32  # one lane per channel of a head
MAX_HEADS = 32  # one warp per head, 1024 threads a block
MAX_TAPS = 16  # a head's logits and offsets, one per lane

_P = ctypes.c_void_p
_I = ctypes.c_int


@dataclass(frozen=True)
class ProjAttnGeometry:
    """The frames of the projection: world(y) = y * size + lo (mm), the
    original-image -> network-input affine (6, row-major), the clamp of
    the original-image pixel to [-1, max(original w, h)] and the network
    input's size (w, h)."""

    size: Tuple[float, float, float]
    lo: Tuple[float, float, float]
    affine: Tuple[float, ...]
    clip_hi: float
    image_size: Tuple[int, int]

    @classmethod
    def of(cls, space_size, space_center, affine, ori_image_size,
           image_size) -> "ProjAttnGeometry":
        """From a capture space (size, centre) in mm, the 2x3 resize
        affine and the original and input image sizes (w, h); lo is
        centre - size / 2 in float32."""
        size = np.asarray(space_size, np.float32)
        lo = np.asarray(space_center, np.float32) - size / np.float32(2.0)
        return cls(tuple(float(v) for v in size), tuple(float(v) for v in lo),
                   tuple(float(v) for v in np.asarray(affine, np.float32).ravel()),
                   float(max(ori_image_size)), tuple(int(v) for v in image_size))

    def consts(self) -> np.ndarray:
        """The 15 float32 values of the kernel's ProjAttnConsts."""
        return np.asarray([*self.size, *self.lo, *self.affine, self.clip_hi, *self.image_size],
                          np.float32)

    def input_uv(self, y: torch.Tensor, cams: torch.Tensor) -> torch.Tensor:
        """Normalised points (B, Q, 3) and cams (B, V, 21) -> (B, V, Q, 2):
        each point's network-input pixel over the input's size, in the
        kernel's op order (world mm y * size + lo, `project_points`, the
        clamp, the affine)."""
        size = torch.tensor(self.size, dtype=y.dtype, device=y.device)
        lo = torch.tensor(self.lo, dtype=y.dtype, device=y.device)
        xy = project_points((y * size + lo)[:, None], cams).clamp(-1.0, self.clip_hi)
        t = self.affine
        qx = xy[..., 0] * t[0] + xy[..., 1] * t[1] + t[2]
        qy = xy[..., 0] * t[3] + xy[..., 1] * t[4] + t[5]
        return torch.stack([qx / self.image_size[0], qy / self.image_size[1]], dim=-1)


def projective_attention_plain(values: Sequence[torch.Tensor], ref: torch.Tensor,
                               offsets: torch.Tensor, logits: torch.Tensor, cams: torch.Tensor,
                               geom: ProjAttnGeometry) -> torch.Tensor:
    """The kernel's function in plain PyTorch: one `F.grid_sample` per
    level over every view and head, in float32 (float64 for float64
    maps); the result in the maps' dtype.  values: L maps (B, V, H_l, W_l,
    M * Dh); ref (B, Q, 3); offsets (B, Q, M, L, P, 2); logits (B, Q, M, L,
    P); cams (B, V, 21) -> (B, V, Q, M * Dh)."""
    dt = values[0].dtype
    work = torch.float64 if dt == torch.float64 else torch.float32
    B, V = values[0].shape[:2]
    D = values[0].shape[-1]
    Q, M, L, P = offsets.shape[1:5]
    Dh = D // M
    uv = geom.input_uv(ref.to(work), cams.to(work))  # (B, V, Q, 2)
    a = torch.softmax(logits.to(work).reshape(B, Q, M, L * P), -1).reshape(B, Q, M, L, P)
    out = torch.zeros((B, V, M, Dh, Q), dtype=work, device=ref.device)
    for level, val in enumerate(values):
        H, W = val.shape[2:4]
        scale = torch.tensor((W, H), dtype=work, device=ref.device)
        loc = uv[:, :, :, None, None] + offsets[:, None, :, :, level].to(work) / scale
        grid = (2.0 * loc - 1.0).permute(0, 1, 3, 2, 4, 5).reshape(B * V * M, Q, P, 2)
        x = val.to(work).reshape(B, V, H, W, M, Dh).permute(0, 1, 4, 5, 2, 3)
        s = F.grid_sample(x.reshape(B * V * M, Dh, H, W), grid, mode="bilinear",
                          padding_mode="zeros", align_corners=False)  # (B V M, Dh, Q, P)
        w = a[:, :, :, level].permute(0, 2, 1, 3)[:, None, :, None]  # (B, 1, M, 1, Q, P)
        out += (s.reshape(B, V, M, Dh, Q, P) * w).sum(-1)
    return out.permute(0, 1, 4, 2, 3).reshape(B, V, Q, D).to(dt)


def _lib():
    from .cuda_build import load

    lib = load("projattn")
    if not getattr(lib, "_fvp_typed", False):
        lib.fvp_projattn.argtypes = [_P] * 4 + [_I] * 10 + [_P] * 6 + [_I] * 5 + [_P]
        lib.fvp_projattn.restype = _I
        lib._fvp_typed = True
    return lib


def check_inputs(values: Sequence[torch.Tensor], ref: torch.Tensor, offsets: torch.Tensor,
                 logits: torch.Tensor, cams: torch.Tensor) -> None:
    """Raise on what the kernel does not take (the wrapper's refusals for
    CUDA tensors; shapes, dtypes and layouts only, so it runs anywhere)."""
    ts = (*values, ref, offsets, logits, cams)
    if any(t.requires_grad for t in ts):
        raise ValueError("projective_attention is forward only: an input requires grad")
    if len({t.device for t in ts}) != 1:
        raise ValueError("the value maps, points, offsets, logits and cams must lie on one "
                         "device")
    if not 0 < len(values) <= MAX_LEVELS:
        raise ValueError(f"projective_attention takes 1..{MAX_LEVELS} levels, got {len(values)}")
    if offsets.dim() != 6 or offsets.shape[-1] != 2:
        raise ValueError(f"offsets of shape {tuple(offsets.shape)}, expected (B, Q, M, L, P, 2)")
    B, Q, M, L, P = offsets.shape[:5]
    D = values[0].shape[-1]
    if L != len(values):
        raise ValueError(f"offsets for {L} levels, {len(values)} value maps")
    if not (0 < M <= MAX_HEADS and D % M == 0 and D // M <= MAX_HEAD_DIM):
        raise ValueError(f"{M} heads of {D} channels: at most {MAX_HEADS} heads of at most "
                         f"{MAX_HEAD_DIM} channels")
    if 2 * L * P > 2 * MAX_TAPS:
        raise ValueError(f"{L} levels x {P} points: at most {MAX_TAPS} taps a head")
    V = cams.shape[1]
    for level, val in enumerate(values):
        if val.dtype != torch.bfloat16:
            raise TypeError(f"value map {level}: dtype {val.dtype}, expected torch.bfloat16")
        if val.dim() != 5 or tuple(val.shape[:2]) != (B, V) or val.shape[-1] != D:
            raise ValueError(f"value map {level} of shape {tuple(val.shape)}, expected "
                             f"({B}, {V}, H, W, {D})")
        if not val.is_contiguous():
            raise ValueError(f"value map {level}: not contiguous")
    for name, t, shape in (("ref", ref, (B, Q, 3)), ("logits", logits, (B, Q, M, L, P)),
                           ("cams", cams, (B, V, 21))):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, expected torch.float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    if offsets.dtype != torch.float32 or not offsets.is_contiguous():
        raise ValueError(f"offsets: {offsets.dtype}, expected contiguous torch.float32")


def projective_attention(values: Sequence[torch.Tensor], ref: torch.Tensor,
                         offsets: torch.Tensor, logits: torch.Tensor, cams: torch.Tensor,
                         geom: ProjAttnGeometry) -> torch.Tensor:
    """values: L maps (B, V, H_l, W_l, M * Dh), bf16 on the card; ref (B,
    Q, 3), offsets (B, Q, M, L, P, 2), logits (B, Q, M, L, P), cams (B, V,
    21) float32 -> (B, V, Q, M * Dh) in the maps' dtype."""
    if ref.device.type == "cpu":
        return projective_attention_plain(values, ref, offsets, logits, cams, geom)
    check_inputs(values, ref, offsets, logits, cams)
    B, Q, M, L, P = offsets.shape[:5]
    V, D = cams.shape[1], values[0].shape[-1]
    out = torch.empty((B, V, Q, D), dtype=torch.bfloat16, device=ref.device)
    maps = [v.data_ptr() for v in values] + [None] * (MAX_LEVELS - L)
    sizes = [n for v in values for n in v.shape[2:4]] + [0] * (2 * (MAX_LEVELS - L))
    consts = geom.consts()
    err = _lib().fvp_projattn(
        *maps, *sizes, L, P, ref.data_ptr(), offsets.data_ptr(), logits.data_ptr(),
        cams.data_ptr(), consts.ctypes.data, out.data_ptr(), B, Q, V, M, D // M,
        _stream(ref.device),
    )
    _raise_on(err, "projective_attention")
    LAUNCHES["projattn"] += 1
    return out
