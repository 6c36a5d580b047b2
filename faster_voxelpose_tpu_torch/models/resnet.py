"""Pose-ResNet 2D heatmap backbone (counterpart of
`faster_voxelpose_tpu/models/resnet.py`, Simple-Baselines style, reference
lib/models/resnet.py): a ResNet-{18,34,50,101,152} trunk, three 4x4
stride-2 transposed convs and a per-joint output conv, heatmaps at a
quarter of the input's resolution.  Stock PyTorch operations (cuDNN):
the JAX package runs the backbone as plain XLA ops, outside its sampling
kernel.

Module names follow the flax modules (`layer2_0.down_conv`,
`deconv_bn1`, `final`), so that `weights.from_jax_variables` maps the
flax paths mechanically, and `weights.convert_backbone` maps an upstream
state dict.  The 3x3 convs pad as flax's padding="SAME" does: at stride
2 on an even side that is (0, 1), where the upstream's torch conv pads
(1, 1), so on even sides the JAX package's backbone, and this one with
it, is not the upstream network (`blocks.same_pads`).

For serving, `PoseResNet.fold()` folds every BatchNorm into the
convolution before it (`blocks.fold_batchnorm`): in eval mode a folded
module runs each conv with its folded weight and bias in the compute
dtype, then ReLU (and the residual add), with no BatchNorm, no float32
activation and no per-forward weight cast before the output conv.  On
the card the conv + bias + ReLU and conv + bias + shortcut + ReLU run as
cuDNN's fused `cudnn_convolution_relu` / `cudnn_convolution_add_relu`;
elsewhere as the conv, then in-place `add_` and `relu_` (`blocks.conv_relu`,
`blocks.conv_add_relu`, shared with the fusion nets' fold).  Training, and
every module never folded, run the unfolded forward.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from ..datasets.images import IMAGENET_MEAN, IMAGENET_STD, normalize_images_device
from ..utils import profiling
from .blocks import (BatchNorm, Conv, Deconv, FoldedModule, conv_add_relu, conv_folded,
                     conv_relu, fold_batchnorm, store_folded)
from .faster_voxelpose import DTYPES


class BasicBlock(nn.Module):
    """2-conv residual block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv(cin, planes, 3, dtype=dtype, stride=stride, use_bias=False)
        self.bn1 = BatchNorm(planes, dtype)
        self.conv2 = Conv(planes, planes, 3, dtype=dtype, use_bias=False)
        self.bn2 = BatchNorm(planes, dtype)
        self.downsample = downsample
        if downsample:
            self.down_conv = Conv(cin, planes, 1, dtype=dtype, stride=stride, use_bias=False)
            self.down_bn = BatchNorm(planes, dtype)

    folded = False  # set by PoseResNet.fold

    def fold_pairs(self) -> List[Tuple[Conv, BatchNorm]]:
        pairs = [(self.conv1, self.bn1), (self.conv2, self.bn2)]
        return pairs + [(self.down_conv, self.down_bn)] if self.downsample else pairs

    def forward(self, x):
        if self.folded and not self.training:
            identity = conv_folded(self.down_conv, x) if self.downsample else x
            return conv_add_relu(self.conv2, conv_relu(self.conv1, x), identity)
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        identity = self.down_bn(self.down_conv(x)) if self.downsample else x
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """1-3-1 bottleneck block (ResNet-50/101/152), the stride on the 3x3."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv(cin, planes, 1, dtype=dtype, use_bias=False)
        self.bn1 = BatchNorm(planes, dtype)
        self.conv2 = Conv(planes, planes, 3, dtype=dtype, stride=stride, use_bias=False)
        self.bn2 = BatchNorm(planes, dtype)
        self.conv3 = Conv(planes, planes * 4, 1, dtype=dtype, use_bias=False)
        self.bn3 = BatchNorm(planes * 4, dtype)
        self.downsample = downsample
        if downsample:
            self.down_conv = Conv(cin, planes * 4, 1, dtype=dtype, stride=stride, use_bias=False)
            self.down_bn = BatchNorm(planes * 4, dtype)

    folded = False  # set by PoseResNet.fold

    def fold_pairs(self) -> List[Tuple[Conv, BatchNorm]]:
        pairs = [(self.conv1, self.bn1), (self.conv2, self.bn2), (self.conv3, self.bn3)]
        return pairs + [(self.down_conv, self.down_bn)] if self.downsample else pairs

    def forward(self, x):
        if self.folded and not self.training:
            out = conv_relu(self.conv2, conv_relu(self.conv1, x))
            identity = conv_folded(self.down_conv, x) if self.downsample else x
            return conv_add_relu(self.conv3, out, identity)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = self.down_bn(self.down_conv(x)) if self.downsample else x
        return F.relu(out + identity)


RESNET_SPEC = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


class PoseResNet(FoldedModule):
    """ResNet trunk + deconv upsampling + per-joint heatmap head, in
    inference: images (B, H, W, 3), normalised, any float dtype ->
    heatmaps (B, H/4, W/4, J) float32.

    A fresh module is a random backbone drawn from torch's generator: the
    trunk's convs Kaiming-normal (fan out, as torchvision's ResNet), the
    deconvs and the output conv N(0, 0.001) (the upstream's
    `init_weights`), BatchNorm at identity.

    `fold()` readies it for serving (the module docstring): the folded
    weights and biases are non-persistent buffers of the convs
    (`folded_weight`, `folded_bias`, channels-last, the compute dtype),
    refolded as `blocks.FoldedModule` says."""

    def __init__(self, num_layers: int = 50, num_joints: int = 15,
                 deconv_filters: Sequence[int] = (256, 256, 256),
                 deconv_kernels: Sequence[int] = (4, 4, 4), deconv_with_bias: bool = False,
                 final_conv_kernel: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        block_cls, layout = RESNET_SPEC[num_layers]
        self.dtype = dtype
        self.conv1 = Conv(3, 64, 7, dtype=dtype, stride=2, padding=3, use_bias=False)
        self.bn1 = BatchNorm(64, dtype)
        self.stages = []
        inplanes = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layout)):
            for b in range(blocks):
                s = (1 if stage == 0 else 2) if b == 0 else 1
                down = b == 0 and (s != 1 or inplanes != planes * block_cls.expansion)
                name = f"layer{stage + 1}_{b}"
                setattr(self, name, block_cls(inplanes, planes, s, down, dtype))
                self.stages.append(name)
                inplanes = planes * block_cls.expansion
        if any(k != 4 for k in deconv_kernels):
            raise ValueError(f"only kernel-4 deconvs are supported, got {tuple(deconv_kernels)}")
        self.num_deconv = len(deconv_filters)
        for i, f in enumerate(deconv_filters):
            setattr(self, f"deconv{i + 1}", Deconv(inplanes, f, 4, 2, 1, 2, deconv_with_bias, dtype))
            setattr(self, f"deconv_bn{i + 1}", BatchNorm(f, dtype))
            inplanes = f
        # a head whose result is cast to float32 at once: float32 sums, as
        # for the fusion nets' heads (blocks.Conv, `float32_out`)
        self.final = Conv(inplanes, num_joints, final_conv_kernel, dtype=dtype,
                          float32_out=True, padding=(final_conv_kernel - 1) // 2)
        with torch.no_grad():
            for name, m in self.named_modules():
                if isinstance(m, Conv) and name != "final":
                    nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu")
        # the normalisation of uint8 frames (images_to_heatmaps), on the
        # module's device, so that it copies nothing from the host
        self.register_buffer("image_mean", torch.as_tensor(IMAGENET_MEAN), persistent=False)
        self.register_buffer("image_std", torch.as_tensor(IMAGENET_STD), persistent=False)

    def fold_pairs(self) -> List[Tuple[nn.Module, BatchNorm]]:
        """(conv or transposed conv, the BatchNorm after it) of every pair
        the fold merges; `final` has no BatchNorm and is not folded."""
        pairs: List[Tuple[nn.Module, BatchNorm]] = [(self.conv1, self.bn1)]
        for name in self.stages:
            pairs += getattr(self, name).fold_pairs()
        return pairs + [(getattr(self, f"deconv{i}"), getattr(self, f"deconv_bn{i}"))
                        for i in range(1, self.num_deconv + 1)]

    def fold(self, owner: Optional[int] = None) -> "PoseResNet":
        """Fold each BatchNorm into the convolution before it
        (`blocks.fold_batchnorm`, in float32 from the live parameters and
        running statistics), stored once in the compute dtype; a refold
        copies into the buffers of the first fold, so a CUDA graph that
        reads them sees it.  Each fold is a set-up span `setup.fold`
        (label "backbone") of the span log's service `owner` (kept for
        later refolds).  Returns the module."""
        if owner is not None:
            self._fold_owner = owner
        pairs = self.fold_pairs()
        with profiling.SPANS.span("setup.fold", owner=self._fold_owner, label="backbone"):
            for conv, bn in pairs:
                # ordinary tensors even under inference mode, so that a
                # refold outside it can write into them
                with torch.inference_mode(False), torch.no_grad():
                    w, b = fold_batchnorm(conv.weight, bn, conv.bias,
                                          out_dim=1 if isinstance(conv, Deconv) else 0)
                    store_folded(conv, w.to(self.dtype).contiguous(
                        memory_format=torch.channels_last), b.to(self.dtype))
        for m in (self, *(getattr(self, name) for name in self.stages)):
            m.folded = True
        self._stamp(t for conv, bn in pairs
                    for d in (conv._parameters, bn._parameters, bn._buffers) for t in d.values())
        return self

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)
        self.serving(x)  # refolds first where a tensor moved
        x = self.stem(x)
        for name in self.stages:
            x = getattr(self, name)(x)
        return self.final(self.upsample(x)).float().permute(0, 2, 3, 1)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """Images (NCHW) cast to the compute dtype, through conv1, bn1 and
        ReLU, then the max pool."""
        x = x.to(self.dtype)
        if self.folded and not self.training:
            x = conv_relu(self.conv1, x)
        else:
            x = F.relu(self.bn1(self.conv1(x)))
        return F.max_pool2d(x, 3, 2, padding=1)

    def upsample(self, x: torch.Tensor) -> torch.Tensor:
        """The transposed convs, each with its BatchNorm and ReLU."""
        for i in range(1, self.num_deconv + 1):
            deconv = getattr(self, f"deconv{i}")
            if self.folded and not self.training:
                x = F.conv_transpose2d(x, deconv.folded_weight, deconv.folded_bias,
                                       deconv.stride, deconv.pad).relu_()
            else:
                x = F.relu(getattr(self, f"deconv_bn{i}")(deconv(x)))
        return x


def build_backbone(cfg: Config, device=None) -> FoldedModule:
    """The backbone that `cfg.BACKBONE` names, in eval mode: 'resnet', a
    `PoseResNet` (RESNET, NUM_JOINTS, COMPUTE_DTYPE), drawn on the host;
    'vitpose', a `vitpose.ViTPose` (VIT, IMAGE_SIZE, NUM_JOINTS,
    COMPUTE_DTYPE), drawn on `device` (None: the host), so that a
    ViTPose-H's 639 M parameters are not drawn on the host to be copied
    or overwritten."""
    if cfg.BACKBONE == "vitpose":
        from .vitpose import build_vitpose  # it imports this module

        return build_vitpose(cfg, device)
    if cfg.BACKBONE != "resnet":
        raise ValueError(f"unknown BACKBONE {cfg.BACKBONE!r}; known: 'resnet', 'vitpose'")
    r = cfg.RESNET
    return PoseResNet(
        num_layers=r.NUM_LAYERS, num_joints=cfg.DATASET.NUM_JOINTS,
        deconv_filters=tuple(r.NUM_DECONV_FILTERS), deconv_kernels=tuple(r.NUM_DECONV_KERNELS),
        deconv_with_bias=r.DECONV_WITH_BIAS, final_conv_kernel=r.FINAL_CONV_KERNEL,
        dtype=DTYPES[cfg.NETWORK.COMPUTE_DTYPE],
    ).eval()


def images_to_heatmaps(backbone: FoldedModule, images: torch.Tensor,
                       color_rgb: bool) -> torch.Tensor:
    """Frames (B, V, ih, iw, 3) -> heatmaps (B, V, ih/4, iw/4, J) float32:
    uint8 frames are decoded BGR, normalised on their device (RGB when
    `color_rgb`); float frames are taken as normalised.  The backbone (a
    `PoseResNet` or a `vitpose.ViTPose`) runs over the B * V frames at
    once."""
    if images.dtype == torch.uint8:
        images = normalize_images_device(images, color_rgb, backbone.image_mean,
                                         backbone.image_std)
    B, V = images.shape[:2]
    hm = backbone(images.reshape(B * V, *images.shape[2:]))
    return hm.reshape(B, V, *hm.shape[1:])
