"""VoxelPose's folded 7x7x7 front as one kernel, with its plain PyTorch
version; launches are counted in `sampling_kernels.LAUNCHES` under
'front3d'.

The wrapper takes its plain version for tensors on the CPU, and for CUDA
tensors launches its hand-written kernel (`csrc/front3d.cu`, built by
`ops/cuda_build.py`) or raises.

front3d
    The folded `blocks.ConvBNRelu` at the head of each of VoxelPose's
    V2VNets (`blocks.UNetFront` at rank 3): x (N, C, X, Y, Z) float32, in
    any strides (the samplers' (N, X, Y, Z, C) cubes permuted) -> the input
    rounded to bf16, the 7x7x7 conv to 16 channels (zero padding 3, stride
    1) with the folded bias, ReLU -> (N, 16, X, Y, Z) bf16 in
    channels-last-3d strides, the layout and dtype cuDNN returned for it.
    It replaces no Pallas kernel: the JAX package has no V2VNet.  On the
    card it takes the place of three launches (the cast, cuDNN's conv with
    its bias on an sm80 "indexed" implicit GEMM, the in-place ReLU).
    Bound on an H100: operations, 2 * 16 * C * 343 per output voxel, 0.458
    ms a request at C = 15 at the bf16 peak, against 0.076 ms for its bytes.
    Design (`csrc/front3d.cu`): persistent blocks walk tiles of 4 x 8 x
    16 outputs along x; each stages its tile's input footprint in shared
    memory in bf16, as 8-channel planes, keeps the 6 of 10 x slabs that
    the next tile shares and loads the new ones behind the tensor work;
    mma.sync m16n8k16 takes each tap's A straight from the planes by
    ldmatrix; the weight, packed at fold time for both orientations
    (`pack_weight`, `_orientation`), streams through a small ring, and
    each A fragment serves the 7 taps of its y row in registers.  Sums
    are float32, the bias is added in float32, and the output is rounded
    once.  The kernel reads the weight and bias through
    their pointers, so a refold into the same buffers (`blocks.keep`)
    reaches a captured graph.

The kernel is forward only and raises on an input that requires grad.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .sampling_kernels import LAUNCHES, _raise_on, _stream

KERNEL, PAD, COUT = 7, 3, 16
MAX_CHANNELS = 32  # two 16-channel chunks

# fvp_front3d's return when the device has too little shared memory per
# block
_ERR_SHARED_MEMORY = -1

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def serves(conv) -> bool:
    """Whether `conv` (a `blocks.Conv`) is a front the kernel takes: rank
    3, kernel 7, stride 1, padding 3, 16 outputs from at most 32 channels,
    with a bias, in bf16."""
    cout, cin = conv.weight.shape[:2]
    return (conv.rank == 3 and conv.kernel == KERNEL and conv.stride == 1 and conv.pad == PAD
            and not conv.same and cout == COUT and cin <= MAX_CHANNELS
            and conv.bias is not None and conv.dtype == conv.out_dtype == torch.bfloat16)


def front3d_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x (N, C, X, Y, Z), the folded conv's weight (16, C, 7, 7, 7) and
    bias (16,) -> (N, 16, X, Y, Z) in the weight's dtype: the folded
    forward's own ops (the cast, the conv with its bias, ReLU)."""
    return F.conv3d(x.to(weight.dtype), weight, bias, 1, PAD).relu_()


def _pack(weight: torch.Tensor, chunks: int) -> torch.Tensor:
    cout, cin = weight.shape[:2]
    w = weight.new_zeros((cout, 16 * chunks, KERNEL, KERNEL, KERNEL))
    w[:, :cin] = weight
    # (nh, r, kc, kh, e, dx, dy, dz) -> (dx, dz, dy, kc, nh, kh, r, e)
    return w.reshape(2, 8, chunks, 2, 8, KERNEL, KERNEL, KERNEL).permute(5, 7, 6, 2, 0, 3, 1, 4)


def pack_weight(weight: torch.Tensor) -> torch.Tensor:
    """The folded weight (16, C, 7, 7, 7) in the kernel's layout, for both
    of its orientations: (orientation, dx, dz, dy, chunk, output half,
    channel half, output, channel).  The channels are padded with zeros to
    16 or 32, each tap's 16 x 16 block of a chunk is four 8x8 matrices
    (outputs 0-7 then 8-15, each channels 0-7 then 8-15), 512 bytes in
    bf16, and the 7 dy taps of one (dx, dz) lie together.  Orientation 1
    is the weight of the cube with x and z swapped (`_orientation`)."""
    chunks = 1 if weight.shape[1] <= 16 else 2
    return torch.stack([_pack(weight, chunks), _pack(weight.transpose(2, 4), chunks)]).contiguous()


def _orientation(X: int, Y: int, Z: int) -> int:
    """1 where the kernel's tiles (4 x, 8 y, 16 z) cover the cube with x
    and z swapped in fewer voxels than as it is (the CPN's 80 x 80 x 20:
    128,000 against 204,800), else 0."""
    def padded(a, b, c):
        return -(-a // 4) * 4 * -(-b // 8) * 8 * -(-c // 16) * 16
    return int(padded(Z, Y, X) < padded(X, Y, Z))


def _lib():
    from .cuda_build import load

    lib = load("front3d")
    if not getattr(lib, "_fvp_typed", False):
        lib.fvp_front3d.argtypes = [_P] * 4 + [_I] * 5 + [_L] * 9 + [_P]
        lib.fvp_front3d.restype = _I
        lib._fvp_typed = True
    return lib


def check_inputs(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 packed: torch.Tensor) -> None:
    """Raise on what the kernel does not take (the wrapper's refusals for
    CUDA tensors; shapes, dtypes and strides only, so it runs anywhere)."""
    ts = (x, weight, bias, packed)
    if any(t.requires_grad for t in ts):
        raise ValueError("front3d is forward only: an input requires grad")
    if {t.device for t in ts} != {x.device}:
        raise ValueError("x, weight, bias and the packed weight must lie on one device")
    if x.dtype != torch.float32:
        raise TypeError(f"x: dtype {x.dtype}, expected torch.float32")
    if any(t.dtype != torch.bfloat16 for t in ts[1:]):
        raise TypeError(f"weight, bias and packed weight: dtypes {weight.dtype}, {bias.dtype}, "
                        f"{packed.dtype}; expected torch.bfloat16")
    if x.dim() != 5:
        raise ValueError(f"x of shape {tuple(x.shape)}, expected (N, C, X, Y, Z)")
    N, C = x.shape[:2]
    if not 0 < C <= MAX_CHANNELS:
        raise ValueError(f"front3d takes 1..{MAX_CHANNELS} channels, got {C}")
    if tuple(weight.shape) != (COUT, C) + (KERNEL,) * 3 or tuple(bias.shape) != (COUT,):
        raise ValueError(f"weight {tuple(weight.shape)} and bias {tuple(bias.shape)}, expected "
                         f"({COUT}, {C}, 7, 7, 7) and ({COUT},)")
    chunks = 1 if C <= 16 else 2
    if tuple(packed.shape) != (2,) + (KERNEL,) * 3 + (chunks, 2, 2, 8, 8) \
            or not packed.is_contiguous() or not bias.is_contiguous():
        raise ValueError(f"packed weight {tuple(packed.shape)}: expected pack_weight's "
                         f"contiguous (2, 7, 7, 7, {chunks}, 2, 2, 8, 8), and a contiguous bias")
    if packed.data_ptr() % 16:
        raise ValueError("the packed weight must start on 16 bytes")
    if min(x.shape[2:]) <= 0 or N <= 0:
        raise ValueError(f"front3d takes a non-empty cube, got {tuple(x.shape)}")


def front3d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            packed: torch.Tensor) -> torch.Tensor:
    """x (N, C, X, Y, Z) float32, any strides; the folded conv's weight
    (16, C, 7, 7, 7), bias (16,) and the weight as `pack_weight` packs it,
    bf16 -> relu(conv + bias) (N, 16, X, Y, Z) bf16, channels-last-3d."""
    if x.device.type == "cpu":
        return front3d_plain(x, weight, bias)
    check_inputs(x, weight, bias, packed)
    N, C, X, Y, Z = x.shape
    out = torch.empty((N, COUT, X, Y, Z), dtype=torch.bfloat16, device=x.device,
                      memory_format=torch.channels_last_3d)
    sN, sC, sX, sY, sZ = x.stride()
    oN, _, oX, oY, oZ = out.stride()
    o = _orientation(X, Y, Z)
    if o:  # the kernel's x is the cube's z and its z the cube's x
        X, Z, sX, sZ, oX, oZ = Z, X, sZ, sX, oZ, oX
    err = _lib().fvp_front3d(
        x.data_ptr(), packed[o].data_ptr(), bias.data_ptr(), out.data_ptr(), N, C, X, Y, Z,
        sN, sC, sX, sY, sZ, oN, oX, oY, oZ, _stream(x.device),
    )
    if err == _ERR_SHARED_MEMORY:
        raise ValueError("front3d: the device has too little shared memory per block")
    _raise_on(err, "front3d")
    LAUNCHES["front3d"] += 1
    return out
