"""The head of VoxelPose's `front_res` block as one kernel, with its plain
PyTorch version; launches are counted in `sampling_kernels.LAUNCHES`
under 'front_res3d'.

The wrapper takes its plain version for tensors on the CPU, and for CUDA
tensors launches its hand-written kernel (`csrc/front_res3d.cu`, built by
`ops/cuda_build.py`) or raises.

front_res3d
    The head of the folded `blocks.ResBlock(16, 32)` that follows each of
    VoxelPose's 7x7x7 fronts (`blocks.UNetFront.front_res` at rank 3):
    x (N, 16, X, Y, Z) bf16, as `front3d` returns it (channels-last-3d;
    any other strides are first copied into that layout) -> h =
    relu(conv3d(x, W1) + b1), 3x3x3 with zero padding 1, and the skip s =
    conv3d(x, Ws) + bs, 1x1x1, each (N, 32, X, Y, Z) bf16 in
    channels-last-3d strides, the layout and dtype cuDNN returned for
    them, so that the block's conv2 (cuDNN's conv + shortcut + ReLU, s as
    the shortcut) reads them unchanged.  It replaces no Pallas kernel:
    the JAX package has no V2VNet.  On the card it takes the place of two
    cuDNN launches on the sm80 "indexed" implicit GEMM (conv1 with its
    bias and ReLU, the skip with its bias).
    Bound on an H100: bytes, 16 channels in and 2 x 32 out, 160 bytes a
    voxel, 0.131 ms a request at 3.35 TB/s (the PRN's ten 64^3 cubes and
    the CPN's 80x80x20 space), against 0.080 ms for its 28,672
    operations a voxel at the bf16 peak.
    Design (`csrc/front_res3d.cu`): persistent blocks walk tiles of 4 x
    8 x 16 outputs along x; each copies its tile's 6 x 10 x 18 input
    footprint into shared memory (two 8-channel planes) by cp.async, the
    next tile's while this one's products run; mma.sync m16n8k16 takes
    each tap's A straight from the planes by ldmatrix, against the 27
    taps' and the skip's weights, packed at fold time for both
    orientations (`pack_weight`, `front3d_kernels._orientation`) and
    resident in shared memory; the skip reuses the centre tap's A; each
    output row leaves through stmatrix in 16-byte writes.  Sums are
    float32, the biases are added in float32, each output is rounded
    once.  The kernel reads the weights and biases through their
    pointers, so a refold into the same buffers (`blocks.keep`) reaches
    a captured graph.

The kernel is forward only and raises on an input that requires grad.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .front3d_kernels import _orientation
from .sampling_kernels import LAUNCHES, _raise_on, _stream

KERNEL, PAD, CIN, COUT = 3, 1, 16, 32
TAPS = KERNEL ** 3

# fvp_front_res3d's return when the device has too little shared memory per
# block
_ERR_SHARED_MEMORY = -1

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def serves(block) -> bool:
    """Whether `block` (a `blocks.ResBlock`) has a head the kernel takes:
    rank 3, its conv1 3x3x3 at stride 1 and padding 1, a projected 1x1x1
    skip, 16 channels in and 32 out, both with a bias, in bf16."""
    if not block.project:
        return False
    conv1, skip = block.conv1, block.skip_conv
    cout, cin = conv1.weight.shape[:2]
    return (conv1.rank == 3 and conv1.kernel == KERNEL and conv1.stride == 1
            and conv1.pad == PAD and not conv1.same
            and skip.kernel == 1 and skip.stride == 1 and skip.pad == 0 and not skip.same
            and (cin, cout) == (CIN, COUT)
            and conv1.bias is not None and skip.bias is not None
            and all(c.dtype == c.out_dtype == torch.bfloat16 for c in (conv1, skip)))


def front_res3d_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, ws: torch.Tensor,
                      bs: torch.Tensor):
    """x (N, 16, X, Y, Z), the folded conv1's weight (32, 16, 3, 3, 3) and
    bias (32,), the folded skip's weight (32, 16, 1, 1, 1) and bias (32,)
    -> (h, s), each (N, 32, X, Y, Z): the folded forward's own ops."""
    return F.conv3d(x, w1, b1, 1, PAD).relu_(), F.conv3d(x, ws, bs)


def _pack(w1: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    # (nt, r, kh, e, dx, dy, dz) -> (dx, dz, dy, nt, kh, r, e)
    taps = w1.reshape(4, 8, 2, 8, KERNEL, KERNEL, KERNEL).permute(4, 6, 5, 0, 2, 1, 3)
    skip = ws.reshape(4, 8, 2, 8).permute(0, 2, 1, 3)
    return torch.cat([taps.reshape(TAPS, 4, 2, 8, 8), skip[None]])


def pack_weight(w1: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """The folded conv1 (32, 16, 3, 3, 3) and skip (32, 16, 1, 1, 1) in the
    kernel's layout, for both of its orientations: (orientation, tap, n8
    tile, channel half, output, channel), taps 0-26 conv1's (dx, dz, dy)
    and tap 27 the skip's.  Each tap's 16 x 32 block is eight 8x8
    matrices (outputs 8 nt .. 8 nt + 7, channels 0-7 then 8-15), 1 KB in
    bf16.  Orientation 1 is the weight of the cube with x and z swapped
    (`front3d_kernels._orientation`)."""
    return torch.stack([_pack(w1, ws), _pack(w1.transpose(2, 4), ws)]).contiguous()


def _lib():
    from .cuda_build import load

    lib = load("front_res3d")
    if not getattr(lib, "_fvp_typed", False):
        lib.fvp_front_res3d.argtypes = [_P] * 6 + [_I] * 4 + [_L] * 8 + [_P]
        lib.fvp_front_res3d.restype = _I
        lib._fvp_typed = True
    return lib


def check_inputs(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, ws: torch.Tensor,
                 bs: torch.Tensor, packed: torch.Tensor) -> None:
    """Raise on what the kernel does not take (the wrapper's refusals for
    CUDA tensors; shapes, dtypes and alignment only, so it runs
    anywhere)."""
    ts = (x, w1, b1, ws, bs, packed)
    if any(t.requires_grad for t in ts):
        raise ValueError("front_res3d is forward only: an input requires grad")
    if {t.device for t in ts} != {x.device}:
        raise ValueError("x, the weights, the biases and the packed weights must lie on one "
                         "device")
    if any(t.dtype != torch.bfloat16 for t in ts):
        raise TypeError(f"front_res3d takes bf16 alone; dtypes {[t.dtype for t in ts]}")
    if x.dim() != 5 or x.shape[1] != CIN:
        raise ValueError(f"x of shape {tuple(x.shape)}, expected (N, {CIN}, X, Y, Z)")
    if (tuple(w1.shape) != (COUT, CIN) + (KERNEL,) * 3 or tuple(ws.shape) != (COUT, CIN, 1, 1, 1)
            or tuple(b1.shape) != (COUT,) or tuple(bs.shape) != (COUT,)):
        raise ValueError(f"weights {tuple(w1.shape)}, {tuple(ws.shape)} and biases "
                         f"{tuple(b1.shape)}, {tuple(bs.shape)}; expected ({COUT}, {CIN}, 3, 3, "
                         f"3), ({COUT}, {CIN}, 1, 1, 1) and ({COUT},)")
    if tuple(packed.shape) != (2, TAPS + 1, 4, 2, 8, 8) or not packed.is_contiguous() \
            or not b1.is_contiguous() or not bs.is_contiguous():
        raise ValueError(f"packed weights {tuple(packed.shape)}: expected pack_weight's "
                         f"contiguous (2, {TAPS + 1}, 4, 2, 8, 8), and contiguous biases")
    if packed.data_ptr() % 16:
        raise ValueError("the packed weights must start on 16 bytes")
    if min(x.shape) <= 0:
        raise ValueError(f"front_res3d takes a non-empty cube, got {tuple(x.shape)}")


def _kernel_layout(x: torch.Tensor) -> bool:
    """Whether the kernel reads x as it lies: channels contiguous, each
    voxel and x itself on 16 bytes."""
    sN, sC, sX, sY, sZ = x.stride()
    return sC == 1 and not any(s % 8 for s in (sN, sX, sY, sZ)) and x.data_ptr() % 16 == 0


def front_res3d(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, ws: torch.Tensor,
                bs: torch.Tensor, packed: torch.Tensor):
    """x (N, 16, X, Y, Z) bf16, any strides; the folded conv1's weight and
    bias, the folded skip's weight and bias, and both as `pack_weight`
    packs them, bf16 -> (relu(conv1 + b1), skip + bs), each (N, 32, X, Y,
    Z) bf16, channels-last-3d."""
    if x.device.type == "cpu":
        return front_res3d_plain(x, w1, b1, ws, bs)
    check_inputs(x, w1, b1, ws, bs, packed)
    if not _kernel_layout(x):
        x = x.clone(memory_format=torch.channels_last_3d)
    N, _, X, Y, Z = x.shape
    h = torch.empty((N, COUT, X, Y, Z), dtype=torch.bfloat16, device=x.device,
                    memory_format=torch.channels_last_3d)
    s = torch.empty_like(h)
    sN, _, sX, sY, sZ = x.stride()
    oN, _, oX, oY, oZ = h.stride()
    o = _orientation(X, Y, Z)
    if o:  # the kernel's x is the cube's z and its z the cube's x
        X, Z, sX, sZ, oX, oZ = Z, X, sZ, sX, oZ, oX
    err = _lib().fvp_front_res3d(
        x.data_ptr(), packed[o].data_ptr(), b1.data_ptr(), bs.data_ptr(), h.data_ptr(),
        s.data_ptr(), N, X, Y, Z, sN, sX, sY, sZ, oN, oX, oY, oZ, _stream(x.device),
    )
    if err == _ERR_SHARED_MEMORY:
        raise ValueError("front_res3d: the device has too little shared memory per block")
    _raise_on(err, "front_res3d")
    LAUNCHES["front_res3d"] += 1
    return h, s
