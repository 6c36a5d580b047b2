"""Reusable conv building blocks, NCHW / NCL PyTorch modules (counterpart
of `faster_voxelpose_tpu/models/blocks.py`, reference
lib/models/cnns_2d.py:12-112 and cnns_1d.py:10-109).

Parameters are float32; each conv casts its input, kernel and bias to the
module's compute dtype, as flax's `dtype=` does, and BatchNorm (eps 1e-5)
runs in float32 and returns the compute dtype.  As in the flax modules,
train mode is an argument, `train`, passed down to every BatchNorm:
running statistics when false, batch statistics (and a running-statistics
update) when true.  Module and parameter names follow the flax modules, so
that `weights.from_jax_variables` maps the flax paths mechanically.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

_CONV = {1: F.conv1d, 2: F.conv2d}
_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d}
_POOL = {1: F.max_pool1d, 2: F.max_pool2d}


def scaled(channels: int, width: float) -> int:
    """Channel count under a width multiplier, rounded to a multiple of 8,
    floor 8; width 1.0 keeps the reference topology."""
    if width == 1.0:
        return channels
    return max(8, int(round(channels * width / 8)) * 8)


def _normal(*shape: int) -> nn.Parameter:
    # reference init: normal(0, 0.001) weights, zero biases
    return nn.Parameter(torch.randn(*shape) * 1e-3)


def same_pads(size: int, kernel: int, stride: int):
    """flax's padding="SAME" of one axis of `size`: (before, after), the
    larger half after.  At stride 1 and an odd kernel that is kernel // 2
    on both sides, as torch pads; at stride 2 on an even side it is
    (kernel // 2 - 1, kernel // 2): a 3x3 stride-2 conv pads (0, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """Convolution, weight (O, I, *k), with flax's padding="SAME" (odd
    kernels; `same_pads` at a stride above 1) or, given `padding`, that
    many pixels on every side.

    With `float32_out` the operands are still rounded to the compute
    dtype, but the sums are kept and returned in float32.  It is set on
    every layer whose result the JAX package casts to float32 at once (the
    heads' last layers).  On the CPU that package rounds such a result to
    bf16 before the cast, so there the port departs from it, within one
    bf16 rounding of the value.  The port follows the TPU instead, where
    the snapshot's evaluation record was made: with a centre heatmap
    rounded to bf16 the held-out scenes lose 0.03 AP to duplicate
    proposals, and with float32 sums they land on the record (see
    `CenterNet`)."""

    def __init__(self, cin: int, cout: int, kernel: int, rank: int = 2,
                 dtype: torch.dtype = torch.float32, float32_out: bool = False,
                 stride: int = 1, padding: Optional[int] = None, use_bias: bool = True):
        super().__init__()
        self.rank, self.dtype, self.kernel, self.stride = rank, dtype, kernel, stride
        self.same = padding is None and stride > 1  # padded per input size
        self.pad = 0 if self.same else (kernel // 2 if padding is None else padding)
        self.out_dtype = torch.promote_types(dtype, torch.float32) if float32_out else dtype
        self.weight = _normal(cout, cin, *(kernel,) * rank)
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None

    def pad_same(self, x):
        """x padded as flax's "SAME" where this conv pads per input size
        (a stride above 1); x itself otherwise."""
        if not self.same:
            return x
        # F.pad takes the last axis first
        return F.pad(x, [p for n in reversed(x.shape[2:])
                         for p in same_pads(n, self.kernel, self.stride)])

    def forward(self, x):
        dt, out = self.dtype, self.out_dtype
        x = self.pad_same(x)
        b = None if self.bias is None else self.bias.to(dt).to(out)
        return _CONV[self.rank](
            x.to(dt).to(out), self.weight.to(dt).to(out), b, stride=self.stride, padding=self.pad,
        )


class Dense(nn.Module):
    """Linear layer in the compute dtype, weight (O, I); `float32_out` as
    for `Conv`."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32,
                 float32_out: bool = False):
        super().__init__()
        self.dtype = dtype
        self.out_dtype = torch.promote_types(dtype, torch.float32) if float32_out else dtype
        self.weight = _normal(cout, cin)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        dt, out = self.dtype, self.out_dtype
        return F.linear(x.to(dt).to(out), self.weight.to(dt).to(out), self.bias.to(dt).to(out))


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 with flax's semantics (momentum 0.9, eps 1e-5).

    Train mode takes the float32 mean and the biased variance
    E[x^2] - E[x]^2 (floored at 0) over the batch and spatial axes, both
    to normalise and for the running update ra = 0.9 ra + 0.1 batch.
    `F.batch_norm(training=True)` would update the running variance with
    the unbiased variance instead, n/(n-1) away from the JAX package's.

    The statistics are taken as per-channel sums over the count.
    `global_sum`, set only inside a data-parallel train step
    (`parallel.mesh`), sums a tensor over the ranks with autograd through
    the sum: the sum, sum of squares and count are then those of the
    global batch, as flax's BatchNorm under a batch-sharded jit takes
    them, and over one rank the step is bit for bit the single process's."""

    global_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, train: bool = False):
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if not train:
            y = F.batch_norm(
                x, self.running_mean, self.running_var, self.weight,
                self.bias, training=False, eps=1e-5,
            )
            return y.to(self.dtype)
        dims = [0] + list(range(2, x.ndim))
        count = x.new_full((x.shape[1],), float(x.numel() // x.shape[1]))
        sums = torch.stack([x.sum(dims), (x * x).sum(dims), count])
        s, s2, n = sums if self.global_sum is None else self.global_sum(sums)
        mean = s / n
        var = (s2 / n - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            self.running_mean.copy_(0.9 * self.running_mean + (1 - 0.9) * mean)
            self.running_var.copy_(0.9 * self.running_var + (1 - 0.9) * var)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(var + 1e-5) * self.weight  # op order of flax's _normalize
        y = (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
        return y.to(self.dtype)


def fold_batchnorm(weight: torch.Tensor, bn: "BatchNorm", bias: Optional[torch.Tensor] = None,
                   out_dim: int = 0):
    """The (weight, bias) of a convolution followed by the inference
    BatchNorm `bn`, as one convolution, in float32: with s = gamma *
    rsqrt(running_var + 1e-5) per output channel, weight * s along
    `out_dim` (0 for a conv's (O, I, *k), 1 for a transposed conv's
    (I, O, *k)) and beta + (bias - running_mean) * s (bias 0 where None)."""
    s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + 1e-5)
    shape = [1] * weight.ndim
    shape[out_dim] = -1
    shift = -bn.running_mean.float() if bias is None else bias.float() - bn.running_mean.float()
    return weight.float() * s.reshape(shape), bn.bias.float() + shift * s


class Deconv(nn.Module):
    """Transposed convolution with torch semantics, weight (I, O, *k).

    The flax module stores the same kernel spatially flipped as (*k, I, O)
    and computes the k2/s2 case as a sub-pixel 1x1 conv; both give
    y[2u + a] = x[u] @ W[:, :, a], which is what conv_transpose computes
    here (`weights.from_jax_variables` undoes the flip)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, pad: int,
                 rank: int = 2, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.rank, self.stride, self.pad, self.dtype = rank, stride, pad, dtype
        self.weight = _normal(cin, cout, *(kernel,) * rank)
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None

    def forward(self, x):
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return _DECONV[self.rank](
            x.to(dt), self.weight.to(dt), b, stride=self.stride, padding=self.pad
        )


class ConvBNRelu(nn.Module):
    """conv(k) + BN + ReLU (reference Basic2DBlock / Basic1DBlock)."""

    def __init__(self, cin, cout, kernel, rank=2, dtype=torch.float32):
        super().__init__()
        self.conv = Conv(cin, cout, kernel, rank, dtype)
        self.bn = BatchNorm(cout, dtype)

    def forward(self, x, train: bool = False):
        return F.relu(self.bn(self.conv(x), train))


class ResBlock(nn.Module):
    """3-3 residual block with BN, 1x1-projected skip on channel change
    (reference Res2DBlock / Res1DBlock)."""

    def __init__(self, cin, cout, rank=2, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv(cin, cout, 3, rank, dtype)
        self.bn1 = BatchNorm(cout, dtype)
        self.conv2 = Conv(cout, cout, 3, rank, dtype)
        self.bn2 = BatchNorm(cout, dtype)
        self.project = cin != cout
        if self.project:
            self.skip_conv = Conv(cin, cout, 1, rank, dtype)
            self.skip_bn = BatchNorm(cout, dtype)
        self.dtype = dtype

    def forward(self, x, train: bool = False):
        res = F.relu(self.bn1(self.conv1(x), train))
        res = self.bn2(self.conv2(res), train)
        skip = self.skip_bn(self.skip_conv(x), train) if self.project else x.to(self.dtype)
        return F.relu(res + skip)


class UpsampleBlock(nn.Module):
    """2x transposed-conv upsample + BN + ReLU (kernel = stride = 2)."""

    def __init__(self, cin, cout, rank=2, dtype=torch.float32):
        super().__init__()
        self.deconv = Deconv(cin, cout, 2, 2, 0, rank, True, dtype)
        self.bn = BatchNorm(cout, dtype)

    def forward(self, x, train: bool = False):
        return F.relu(self.bn(self.deconv(x), train))


class EncoderDecoder(nn.Module):
    """Two-level U-Net trunk 32 -> 64 -> 128 -> 64 -> 32 with residual
    skips (reference EncoderDecorder), for rank 1 or 2."""

    def __init__(self, rank=2, dtype=torch.float32, width=1.0):
        super().__init__()
        c32, c64, c128 = (scaled(c, width) for c in (32, 64, 128))
        self.rank = rank
        self.skip_res1 = ResBlock(c32, c32, rank, dtype)
        self.encoder_res1 = ResBlock(c32, c64, rank, dtype)
        self.skip_res2 = ResBlock(c64, c64, rank, dtype)
        self.encoder_res2 = ResBlock(c64, c128, rank, dtype)
        self.mid_res = ResBlock(c128, c128, rank, dtype)
        self.decoder_res2 = ResBlock(c128, c128, rank, dtype)
        self.decoder_upsample2 = UpsampleBlock(c128, c64, rank, dtype)
        self.decoder_res1 = ResBlock(c64, c64, rank, dtype)
        self.decoder_upsample1 = UpsampleBlock(c64, c32, rank, dtype)

    def forward(self, x, train: bool = False):
        pool = _POOL[self.rank]
        skip1 = self.skip_res1(x, train)
        x = self.encoder_res1(pool(x, 2), train)
        skip2 = self.skip_res2(x, train)
        x = self.encoder_res2(pool(x, 2), train)
        x = self.mid_res(x, train)
        x = self.decoder_upsample2(self.decoder_res2(x, train), train) + skip2
        x = self.decoder_upsample1(self.decoder_res1(x, train), train) + skip1
        return x


class UNetFront(nn.Module):
    """Front 7-wide conv block + residual widen to 32 channels, shared by
    P2PNet / CenterNet / C2CNet (reference front_layers)."""

    def __init__(self, cin, rank=2, dtype=torch.float32, width=1.0):
        super().__init__()
        c16, c32 = scaled(16, width), scaled(32, width)
        self.front_basic = ConvBNRelu(cin, c16, 7, rank, dtype)
        self.front_res = ResBlock(c16, c32, rank, dtype)

    def forward(self, x, train: bool = False):
        return self.front_res(self.front_basic(x, train), train)

