"""WeightNet's folded front as one kernel, with its plain PyTorch version;
launches are counted in `sampling_kernels.LAUNCHES` under
'weightnet_front'.

The wrapper takes its plain version for tensors on the CPU, and for CUDA
tensors launches its hand-written kernel (`csrc/weightnet.cu`, built by
`ops/cuda_build.py`) or raises.

weightnet_front
    The folded WeightNet's trunk before its MLP (`models/cnns.py`): feats
    (M, J, H, W) float32 -> per joint-plane map the input rounded to the
    compute dtype, the 3x3 conv from 1 to C channels (zero padding 1) with
    the folded bias, ReLU, the 2x2 max pool and the mean over the pooled
    positions -> (M*J, C) in the compute dtype (the folded weight's,
    float32 or bf16).  It replaces no Pallas kernel: the JAX package's
    WeightNet (faster_voxelpose_tpu/models/cnns.py) is flax layers.  On the
    card it takes the place of four library launches (the reshape copy and
    cast, cuDNN's one-channel conv + bias + ReLU on the CUDA cores, an NCHW
    max pool over the conv output, the mean).  Bound on an H100:
    operations, 2 * M*J * H*W * C * 9 float32 flops on the CUDA cores,
    about 18 us at Shelf (M*J = 510, 64x64, C = 32) at 67 TFLOP/s, against
    2.5 us for its bytes (the float32 maps in, M*J*C values out).  Design
    (`csrc/weightnet.cu`): one block per map stages it with a zero halo in
    shared memory through the strides it arrives with, threads own strips
    of pooled positions with their input patch in registers, and the conv
    output never leaves the SM; per-channel sums reduce by warp shuffles.
    The operands are rounded where the folded library chain rounds them
    (the input, the conv output: once after the 2x2 max, since rounding is
    monotone), the sums are float32, the mean is rounded once.  The kernel
    reads the weight and bias through their pointers, so a refold into
    the same buffers (`blocks.store_folded`) reaches a captured graph.

The kernel is forward only and raises on an input that requires grad.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .sampling_kernels import LAUNCHES, _raise_on, _stream

MAX_CHANNELS = 64  # the kernel keeps two channel sums a lane
DTYPES = (torch.float32, torch.bfloat16)

# fvp_weightnet's return when the map needs more shared memory per block
# than the device has
_ERR_SHARED_MEMORY = -1

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def weightnet_front_plain(feats: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """feats (M, J, H, W), the folded conv's weight (C, 1, 3, 3) and bias
    (C,) -> (M*J, C) in the weight's dtype: the folded forward's own ops
    (cast, conv + bias, ReLU, 2x2 max pool, mean)."""
    M, J, H, W = feats.shape
    x = feats.reshape(M * J, 1, H, W).to(weight.dtype)
    y = F.conv2d(x, weight, bias, 1, 1).relu_()
    return F.max_pool2d(y, 2).mean(dim=(2, 3))


def _lib():
    from .cuda_build import load

    lib = load("weightnet")
    if not getattr(lib, "_fvp_typed", False):
        lib.fvp_weightnet.argtypes = [_P] * 4 + [_I] * 5 + [_L] * 4 + [_I, _P]
        lib.fvp_weightnet.restype = _I
        lib._fvp_typed = True
    return lib


def check_inputs(feats: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> None:
    """Raise on what the kernel does not take (the wrapper's refusals for
    CUDA tensors; shapes, dtypes and strides only, so it runs anywhere)."""
    if any(t.requires_grad for t in (feats, weight, bias)):
        raise ValueError("weightnet_front is forward only: an input requires grad")
    if {t.device for t in (feats, weight, bias)} != {feats.device}:
        raise ValueError("feats, weight and bias must lie on one device")
    if feats.dtype != torch.float32:
        raise TypeError(f"feats: dtype {feats.dtype}, expected torch.float32")
    if weight.dtype not in DTYPES or bias.dtype != weight.dtype:
        raise TypeError(f"weight and bias: dtypes {weight.dtype}, {bias.dtype}; expected one of "
                        f"{DTYPES}")
    if feats.dim() != 4:
        raise ValueError(f"feats of shape {tuple(feats.shape)}, expected (M, J, H, W)")
    C = weight.shape[0]
    if tuple(weight.shape) != (C, 1, 3, 3) or tuple(bias.shape) != (C,):
        raise ValueError(f"weight {tuple(weight.shape)} and bias {tuple(bias.shape)}, expected "
                         "(C, 1, 3, 3) and (C,)")
    if not 0 < C <= MAX_CHANNELS:
        raise ValueError(f"weightnet_front takes 1..{MAX_CHANNELS} channels, got {C}")
    # (C, 1, 3, 3) contiguous or channels-last: element (o, 0, kh, kw) at o*9 + kh*3 + kw
    if (weight.stride(2), weight.stride(3)) != (3, 1) or (C > 1 and weight.stride(0) != 9) \
            or not bias.is_contiguous():
        raise ValueError(f"weight strides {weight.stride()}: expected 9 * o + 3 * kh + kw")
    M, J, H, W = feats.shape
    if H <= 0 or W <= 0 or H % 2 or W % 2:
        raise ValueError(f"weightnet_front takes even map sides, got {H}x{W}")
    if not 0 < M * J < 2 ** 31:
        raise ValueError(f"weightnet_front takes 1..2^31-1 maps, got {M * J}")


def weightnet_front(feats: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """feats (M, J, H, W) float32, any strides; the folded conv's weight
    (C, 1, 3, 3) and bias (C,), float32 or bf16 -> (M*J, C) in their
    dtype."""
    if feats.device.type == "cpu":
        return weightnet_front_plain(feats, weight, bias)
    check_inputs(feats, weight, bias)
    M, J, H, W = feats.shape
    C = weight.shape[0]
    out = torch.empty((M * J, C), dtype=weight.dtype, device=feats.device)
    err = _lib().fvp_weightnet(
        feats.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(), M, J, H, W, C,
        *feats.stride(), int(weight.dtype == torch.bfloat16), _stream(feats.device),
    )
    if err == _ERR_SHARED_MEMORY:
        raise ValueError(f"weightnet_front: {H}x{W} maps need more shared memory per block than "
                         "the device has")
    _raise_on(err, "weightnet_front")
    LAUNCHES["weightnet_front"] += 1
    return out
