"""Reusable conv building blocks, NCHW / NCL PyTorch modules (counterpart
of `faster_voxelpose_tpu/models/blocks.py`, reference
lib/models/cnns_2d.py:12-112 and cnns_1d.py:10-109).

Parameters are float32; each conv casts its input, kernel and bias to the
module's compute dtype, as flax's `dtype=` does, and BatchNorm (eps 1e-5)
runs in float32 and returns the compute dtype.  As in the flax modules,
train mode is an argument, `train`, passed down to every layer:
running statistics when false, batch statistics (and a running-statistics
update) when true.  Module and parameter names follow the flax modules, so
that `weights.from_jax_variables` maps the flax paths mechanically.

For serving, every served module (the fusion model, the Pose-ResNet and
the ViTPose) is a `FoldedModule`, and its one `FoldedModule.fold`
prepares its layers' weights once (`fold_layers`): each BatchNorm folded
into the conv before it (`fold_batchnorm`; the pairs each block declares
in `FOLD_PAIRS`), every weight cast to the compute dtype.  A folded layer
outside train mode (`runs_folded`) runs on those: each conv with its
bias, and its ReLU (`conv_relu`) or its block's shortcut and ReLU
(`conv_add_relu`), as one cuDNN call on the card and as the conv, then
in-place `add_` and `relu_`, elsewhere; no BatchNorm, no float32
activation and no per-forward weight cast.  `HeatmapBackbone` is the
deconv heatmap head that both 2D backbones end in.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..datasets.images import IMAGENET_MEAN, IMAGENET_STD
from ..ops import front3d_kernels, front_res3d_kernels
from ..utils import profiling

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}
_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


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

    folded = False  # set by `fold_layers`: the forward then runs the folded weights

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

    def forward(self, x, train: bool = False):
        dt, out = self.dtype, self.out_dtype
        if runs_folded(self, train):
            return conv_folded(self, x.to(dt).to(out))
        x = self.pad_same(x)
        b = None if self.bias is None else self.bias.to(dt).to(out)
        return _CONV[self.rank](
            x.to(dt).to(out), self.weight.to(dt).to(out), b, stride=self.stride, padding=self.pad,
        )


class Dense(nn.Module):
    """Linear layer in the compute dtype, weight (O, I); `float32_out` as
    for `Conv`."""

    folded = False  # as Conv's

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32,
                 float32_out: bool = False):
        super().__init__()
        self.dtype = dtype
        self.out_dtype = torch.promote_types(dtype, torch.float32) if float32_out else dtype
        self.weight = _normal(cout, cin)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x, train: bool = False):
        dt, out = self.dtype, self.out_dtype
        if runs_folded(self, train):
            return F.linear(x.to(dt).to(out), self.folded_weight, self.folded_bias)
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


def runs_folded(layer: nn.Module, train: bool) -> bool:
    """Whether `layer`'s forward runs its folded weights: a layer folded
    by `FoldedModule.fold`, outside train mode (`train` and the module's
    own `training` both false)."""
    return layer.folded and not (train or layer.training)


def conv_folded(conv: "Conv", x: torch.Tensor) -> torch.Tensor:
    """conv's folded convolution of x, its bias added."""
    return _CONV[conv.rank](conv.pad_same(x), conv.folded_weight, conv.folded_bias, conv.stride,
                            conv.pad)


def deconv_folded(deconv: "Deconv", x: torch.Tensor) -> torch.Tensor:
    """deconv's folded transposed convolution of x, its bias added."""
    return _DECONV[deconv.rank](x, deconv.folded_weight, deconv.folded_bias, deconv.stride,
                                deconv.pad)


def _cudnn_operands(conv: "Conv", x: torch.Tensor):
    """(x, weight, stride, padding, dilation) of conv's folded convolution
    as cuDNN's fused ops take them, in 2D or 3D: a rank-1 conv as one of
    unit height (views, no copy)."""
    x, w = conv.pad_same(x), conv.folded_weight
    if conv.rank == 1:
        return x.unsqueeze(2), w.unsqueeze(2), (1, conv.stride), (0, conv.pad), (1, 1)
    r = conv.rank
    return x, w, (conv.stride,) * r, (conv.pad,) * r, (1,) * r


def conv_relu(conv: "Conv", x: torch.Tensor) -> torch.Tensor:
    """relu(conv's folded convolution of x): one cuDNN call on the card."""
    if x.is_cuda:
        x2, w, stride, pad, dil = _cudnn_operands(conv, x)
        y = torch.cudnn_convolution_relu(x2, w, conv.folded_bias, stride, pad, dil, 1)
        return y.squeeze(2) if conv.rank == 1 else y
    return conv_folded(conv, x).relu_()


def conv_add_relu(conv: "Conv", x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """relu(conv's folded convolution of x + z), z the block's shortcut:
    one cuDNN call on the card."""
    if x.is_cuda:
        x2, w, stride, pad, dil = _cudnn_operands(conv, x)
        z2 = z.unsqueeze(2) if conv.rank == 1 else z
        y = torch.cudnn_convolution_add_relu(x2, w, z2, 1.0, conv.folded_bias, stride, pad,
                                             dil, 1)
        return y.squeeze(2) if conv.rank == 1 else y
    return conv_folded(conv, x).add_(z).relu_()


def keep(layer: nn.Module, name: str, value: Optional[torch.Tensor]) -> None:
    """Keep a served tensor as the layer's non-persistent buffer `name` (so
    that `state_dict()` keeps its keys); a refold copies into the buffer of
    the first fold, so that a CUDA graph that reads it sees it."""
    if name not in layer._buffers:
        layer.register_buffer(name, value, persistent=False)
    elif value is not None:
        layer._buffers[name].copy_(value)


def store_folded(layer: nn.Module, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    """Keep a layer's served weight and bias as its buffers `folded_weight`
    and `folded_bias` (`keep`)."""
    keep(layer, "folded_weight", weight)
    keep(layer, "folded_bias", bias)


def fold_layers(module: nn.Module) -> List[torch.Tensor]:
    """Prepare the served weights of every layer under `module` from its
    live parameters: each conv, transposed conv and linear layer, its
    weight and bias with the BatchNorm after it folded in (`fold_batchnorm`,
    in float32; each block names its pairs in `FOLD_PAIRS`, (layer,
    BatchNorm) attribute names, and a name the block lacks is skipped),
    rounded to the layer's compute dtype and kept in its output dtype
    (float32 for a `float32_out` layer); torch's own `nn.Conv2d`,
    `nn.Linear` and `nn.LayerNorm` (a transformer's trunk) rounded to
    `module.dtype`.  4D kernels are channels-last and 5D kernels
    channels-last-3d, kept as `store_folded` keeps them, and a 7x7x7
    front that `front3d_kernels.serves` also keeps its weight packed for
    that kernel (`front3d_weight`), and a `ResBlock` whose head
    `front_res3d_kernels.serves` keeps its conv1 and skip packed for
    that one (`front_res3d_weight`); then the layer's forward runs on them
    outside train mode (`runs_folded`).  Returns the tensors the fold
    read.  Run it under `torch.no_grad()`, and outside inference mode, so
    that a refold outside it can write into the buffers."""
    bn_after = {}
    for m in module.modules():
        for layer, bn in getattr(m, "FOLD_PAIRS", ()):
            if hasattr(m, layer):
                bn_after[getattr(m, layer)] = getattr(m, bn)
    read = []
    for layer in module.modules():
        if isinstance(layer, (Conv, Deconv, Dense)):
            dt = layer.dtype
        elif isinstance(layer, (nn.Conv2d, nn.Linear, nn.LayerNorm)):
            dt = module.dtype
        else:
            continue
        w, b, bn = layer.weight, layer.bias, bn_after.get(layer)
        if bn is not None:
            w, b = fold_batchnorm(w, bn, b, out_dim=1 if isinstance(layer, Deconv) else 0)
        out = getattr(layer, "out_dtype", dt)
        w = w.to(dt, copy=True).to(out)
        if w.ndim == 4:
            w = w.contiguous(memory_format=torch.channels_last)
        elif w.ndim == 5:
            w = w.contiguous(memory_format=torch.channels_last_3d)
        store_folded(layer, w, None if b is None else b.to(dt, copy=True).to(out))
        if isinstance(layer, Conv) and front3d_kernels.serves(layer):
            keep(layer, "front3d_weight", front3d_kernels.pack_weight(w))
        layer.folded = True
        read += layer._parameters.values()
        if bn is not None:
            read += [*bn._parameters.values(), *bn._buffers.values()]
    for block in module.modules():
        if isinstance(block, ResBlock) and front_res3d_kernels.serves(block):
            keep(block, "front_res3d_weight", front_res3d_kernels.pack_weight(
                block.conv1.folded_weight, block.skip_conv.folded_weight))
    return read


def _unstamp(module: "FoldedModule", *_) -> None:
    """Make the next `sync_fold` refold."""
    module._fold_stamp = None


class FoldedModule(nn.Module):
    """A module that serves weights prepared once in its compute dtype
    (`fold`: BatchNorms folded into the convolutions before them, weights
    cast), in non-persistent buffers, so that `state_dict()` keeps its
    keys.  A folded module in eval mode checks before each forward whether
    a tensor the fold read has changed since (`sync_fold`) and then
    refolds into the same buffers; inside a CUDA graph capture it does not
    check, so the capture launches nothing of the fold's, and the graph's
    owner checks before each replay."""

    folded = False
    FOLD_LABEL = ""  # the label of its `setup.fold` spans

    def __init__(self):
        super().__init__()
        self._fold_owner: Optional[int] = None  # the span log's service of `setup.fold`
        self._fold_tensors: List[torch.Tensor] = []  # the tensors the fold read
        self._fold_stamp: Optional[List[int]] = None  # their version counters then
        self.register_load_state_dict_post_hook(_unstamp)

    def fold(self, owner: Optional[int] = None) -> "FoldedModule":
        """Prepare the served weights from the live parameters and running
        statistics (`fold_layers`, then `fold_extra`); outside train mode
        the folded layers then run on them, train mode runs the unfolded
        forward.  A refold copies into the buffers of the first fold, so a
        CUDA graph that reads them sees it.  Each fold is a set-up span
        `setup.fold` (label `FOLD_LABEL`) of the span log's service `owner`
        (kept for later refolds).  Keeps the tensors the fold read and
        their version counters; inference tensors (made under
        torch.inference_mode) keep no version counter: only a reload
        refolds from those.  Returns the module."""
        if owner is not None:
            self._fold_owner = owner
        # ordinary tensors even under inference mode, so that a refold
        # outside it can write into them
        with profiling.SPANS.span("setup.fold", owner=self._fold_owner, label=self.FOLD_LABEL), \
                torch.inference_mode(False), torch.no_grad():
            read = fold_layers(self) + self.fold_extra()
        self.folded = True
        self._fold_tensors = [t for t in read if t is not None and not t.is_inference()]
        self._fold_stamp = [t._version for t in self._fold_tensors]
        return self

    def fold_extra(self) -> List[torch.Tensor]:
        """What the fold prepares besides its layers' weights, inside the
        fold's span and modes; returns the tensors it read."""
        return []

    def sync_fold(self) -> bool:
        """Refold where a tensor the fold read has changed since: an
        in-place write moves its version counter (`load_state_dict`, an
        optimiser step, a running-statistics update; not a write through
        `.data`), and after `load_state_dict`, which may put new tensors in
        place (`assign=True`), it always refolds.  Returns whether it
        refolded (never on a module not folded)."""
        if not self.folded or self._fold_stamp == [t._version for t in self._fold_tensors]:
            return False
        self.fold()
        return True

    def serving(self, x: torch.Tensor) -> bool:
        """Whether a forward on x runs the folded weights (a folded module
        in eval mode), refolded first where a tensor moved, except inside
        a CUDA graph capture."""
        if not self.folded or self.training:
            return False
        if not (x.is_cuda and torch.cuda.is_current_stream_capturing()):
            self.sync_fold()
        return True


class Deconv(nn.Module):
    """Transposed convolution with torch semantics, weight (I, O, *k).

    The flax module stores the same kernel spatially flipped as (*k, I, O)
    and computes the k2/s2 case as a sub-pixel 1x1 conv; both give
    y[2u + a] = x[u] @ W[:, :, a], which is what conv_transpose computes
    here (`weights.from_jax_variables` undoes the flip)."""

    folded = False  # as Conv's

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

    FOLD_PAIRS = (("conv", "bn"),)

    def __init__(self, cin, cout, kernel, rank=2, dtype=torch.float32):
        super().__init__()
        self.conv = Conv(cin, cout, kernel, rank, dtype)
        self.bn = BatchNorm(cout, dtype)

    def forward(self, x, train: bool = False):
        if runs_folded(self.conv, train):
            conv = self.conv
            if "front3d_weight" in conv._buffers:  # VoxelPose's 7x7x7 fronts: one kernel
                return front3d_kernels.front3d(x, conv.folded_weight, conv.folded_bias,
                                               conv.front3d_weight)
            x = x.to(conv.dtype)
            # cuDNN's fused conv + bias + ReLU runs channels-last rows of a
            # multiple of 8 channels on the tensor cores; at the nets'
            # fronts' 15 or 17 joints it falls back to an engine up to 9x
            # slower than the plain conv on an H100 (7x7, bf16)
            if x.shape[1] % 8:
                return conv_folded(self.conv, x).relu_()
            return conv_relu(self.conv, x)
        return F.relu(self.bn(self.conv(x, train), train))


class ResBlock(nn.Module):
    """3-3 residual block with BN, 1x1-projected skip on channel change
    (reference Res2DBlock / Res1DBlock)."""

    FOLD_PAIRS = (("conv1", "bn1"), ("conv2", "bn2"), ("skip_conv", "skip_bn"))

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
        if runs_folded(self.conv1, train):
            x = x.to(self.dtype)
            if "front_res3d_weight" in self._buffers:  # VoxelPose's front_res: one kernel
                c1, sk = self.conv1, self.skip_conv
                h, skip = front_res3d_kernels.front_res3d(
                    x, c1.folded_weight, c1.folded_bias, sk.folded_weight, sk.folded_bias,
                    self.front_res3d_weight)
                return conv_add_relu(self.conv2, h, skip)
            skip = conv_folded(self.skip_conv, x) if self.project else x
            return conv_add_relu(self.conv2, conv_relu(self.conv1, x), skip)
        res = F.relu(self.bn1(self.conv1(x, train), train))
        res = self.bn2(self.conv2(res, train), train)
        skip = self.skip_bn(self.skip_conv(x, train), train) if self.project else x.to(self.dtype)
        return F.relu(res + skip)


class UpsampleBlock(nn.Module):
    """2x transposed-conv upsample + BN + ReLU (kernel = stride = 2)."""

    FOLD_PAIRS = (("deconv", "bn"),)

    def __init__(self, cin, cout, rank=2, dtype=torch.float32):
        super().__init__()
        self.deconv = Deconv(cin, cout, 2, 2, 0, rank, True, dtype)
        self.bn = BatchNorm(cout, dtype)

    def forward(self, x, train: bool = False):
        d = self.deconv
        if runs_folded(d, train):
            return deconv_folded(d, x.to(d.dtype)).relu_()
        return F.relu(self.bn(d(x), train))


class EncoderDecoder(nn.Module):
    """Two-level U-Net trunk 32 -> 64 -> 128 -> 64 -> 32 with residual
    skips (reference EncoderDecorder), for rank 1, 2 or 3 (VoxelPose's
    V2VNet trunk)."""

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
    P2PNet / CenterNet / C2CNet and, at rank 3, VoxelPose's V2VNet
    (reference front_layers)."""

    def __init__(self, cin, rank=2, dtype=torch.float32, width=1.0):
        super().__init__()
        c16, c32 = scaled(16, width), scaled(32, width)
        self.front_basic = ConvBNRelu(cin, c16, 7, rank, dtype)
        self.front_res = ResBlock(c16, c32, rank, dtype)

    def forward(self, x, train: bool = False):
        return self.front_res(self.front_basic(x, train), train)



class HeatmapBackbone(FoldedModule):
    """A 2D backbone: images (B, H, W, 3), normalised, any float dtype ->
    heatmaps (B, H/4, W/4, J) float32, through the subclass's trunk and
    the Simple-Baselines head that the Pose-ResNet and the ViTPose end in
    (`build_head`): 4x4 stride-2 transposed convs `deconv{i}`, each with
    its BatchNorm `deconv_bn{i}` and ReLU (`upsample_levels` hands out
    every one's output), then the output conv `final`,
    whose sums are float32 (`Conv`, `float32_out`), folded as every other
    layer.  The head's layers are the backbone's own attributes, so that
    their state-dict keys are the flax and upstream names.  It also holds
    the normalisation of uint8 frames (`image_mean`, `image_std`) on its
    device, so that `resnet.images_to_heatmaps` copies nothing from the
    host."""

    FOLD_PAIRS = ()  # the trunk's; `build_head` adds the head's

    def build_head(self, cin: int, filters: Sequence[int], with_bias: bool, num_joints: int,
                   final_kernel: int, dtype: torch.dtype) -> None:
        """The head on cin channels (the deconvs, then `final`, drawn in
        that order) and the normalisation buffers."""
        self.num_deconv = len(filters)
        for i, f in enumerate(filters, 1):
            setattr(self, f"deconv{i}", Deconv(cin, f, 4, 2, 1, 2, with_bias, dtype))
            setattr(self, f"deconv_bn{i}", BatchNorm(f, dtype))
            cin = f
        self.FOLD_PAIRS = self.FOLD_PAIRS + tuple(
            (f"deconv{i}", f"deconv_bn{i}") for i in range(1, self.num_deconv + 1))
        self.final = Conv(cin, num_joints, final_kernel, dtype=dtype, float32_out=True,
                          padding=(final_kernel - 1) // 2)
        self.register_buffer("image_mean", torch.as_tensor(IMAGENET_MEAN), persistent=False)
        self.register_buffer("image_std", torch.as_tensor(IMAGENET_STD), persistent=False)

    def _upsampled(self, x: torch.Tensor) -> Iterator[torch.Tensor]:
        """Each transposed conv's output, with its BatchNorm and ReLU, in
        turn; a caller that keeps only the last frees each one as the
        next is made."""
        for i in range(1, self.num_deconv + 1):
            deconv = getattr(self, f"deconv{i}")
            if runs_folded(deconv, False):
                x = deconv_folded(deconv, x).relu_()
            else:
                x = F.relu(getattr(self, f"deconv_bn{i}")(deconv(x)))
            yield x

    def upsample_levels(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every transposed conv's output (NCHW, the compute dtype),
        coarsest first (MvP's feature levels)."""
        return list(self._upsampled(x))

    def upsample(self, x: torch.Tensor) -> torch.Tensor:
        """The transposed convs, each with its BatchNorm and ReLU."""
        for x in self._upsampled(x):
            pass
        return x

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Heatmaps (B, H, W, J) float32 of the trunk's features x (NCHW)."""
        return self.final(self.upsample(x)).float().permute(0, 2, 3, 1)
