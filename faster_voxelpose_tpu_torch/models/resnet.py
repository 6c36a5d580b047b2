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

For serving, `FoldedModule.fold()` (label "backbone", as every served
module's: `blocks.fold_layers`) folds every BatchNorm into the
convolution before it (`blocks.fold_batchnorm`; the pairs each block
declares in `FOLD_PAIRS`) and casts `final` once: in eval mode a folded
module runs each conv with its folded weight and bias in the compute
dtype, then ReLU (and the residual add), with no BatchNorm, no float32
activation and no per-forward weight cast.  On the card the conv + bias +
ReLU and conv + bias + shortcut + ReLU run as cuDNN's fused
`cudnn_convolution_relu` / `cudnn_convolution_add_relu`; elsewhere as the
conv, then in-place `add_` and `relu_` (`blocks.conv_relu`,
`blocks.conv_add_relu`, shared with the fusion nets).  The deconv head
and the output conv are `blocks.HeatmapBackbone`'s, shared with the
ViTPose.  Training, and every module never folded, run the unfolded
forward.

`build_backbone` builds the backbone that a config names, this one or
the ViTPose (`vitpose.py`), and `images_to_heatmaps` runs either on
frames; `images_to_features` runs this one to its transposed convs'
outputs, the feature levels MvP (`mvp.py`) reads.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from ..datasets.images import normalize_images_device
from .blocks import (BatchNorm, Conv, HeatmapBackbone, conv_add_relu, conv_folded, conv_relu,
                     runs_folded)
from .faster_voxelpose import DTYPES
from .vitpose import build_vitpose


class BasicBlock(nn.Module):
    """2-conv residual block (ResNet-18/34)."""

    expansion = 1
    FOLD_PAIRS = (("conv1", "bn1"), ("conv2", "bn2"), ("down_conv", "down_bn"))

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

    def forward(self, x):
        if runs_folded(self.conv1, False):
            identity = conv_folded(self.down_conv, x) if self.downsample else x
            return conv_add_relu(self.conv2, conv_relu(self.conv1, x), identity)
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        identity = self.down_bn(self.down_conv(x)) if self.downsample else x
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """1-3-1 bottleneck block (ResNet-50/101/152), the stride on the 3x3."""

    expansion = 4
    FOLD_PAIRS = (("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3"),
                  ("down_conv", "down_bn"))

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

    def forward(self, x):
        if runs_folded(self.conv1, False):
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


class PoseResNet(HeatmapBackbone):
    """ResNet trunk + deconv upsampling + per-joint heatmap head
    (`blocks.HeatmapBackbone`), in inference: images (B, H, W, 3),
    normalised, any float dtype -> heatmaps (B, H/4, W/4, J) float32.

    A fresh module is a random backbone drawn from torch's generator: the
    trunk's convs Kaiming-normal (fan out, as torchvision's ResNet), the
    deconvs and the output conv N(0, 0.001) (the upstream's
    `init_weights`), BatchNorm at identity.

    `fold()` readies it for serving (the module docstring): the folded
    weights and biases are non-persistent buffers of the convs
    (`folded_weight`, `folded_bias`, channels-last, the compute dtype),
    refolded as `blocks.FoldedModule` says."""

    FOLD_LABEL = "backbone"
    FOLD_PAIRS = (("conv1", "bn1"),)

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
        self.build_head(inplanes, deconv_filters, deconv_with_bias, num_joints, final_conv_kernel,
                        dtype)
        with torch.no_grad():
            for name, m in self.named_modules():
                if isinstance(m, Conv) and name != "final":
                    nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu")

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.head(self.trunk(images))

    def features(self, images: torch.Tensor) -> List[torch.Tensor]:
        """Images (B, H, W, 3), normalised -> each transposed conv's
        output after its BatchNorm and ReLU, (B, C, H/16, W/16), (B, C,
        H/8, W/8) and (B, C, H/4, W/4) in the compute dtype, channels-last
        strides on the card; no output conv (MvP's feature levels)."""
        return self.upsample_levels(self.trunk(images))

    def trunk(self, images: torch.Tensor) -> torch.Tensor:
        """Images (B, H, W, 3) through the stem and the residual stages
        (NCHW)."""
        x = images.permute(0, 3, 1, 2)
        self.serving(x)  # refolds first where a tensor moved
        x = self.stem(x)
        for name in self.stages:
            x = getattr(self, name)(x)
        return x

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """Images (NCHW) cast to the compute dtype, through conv1, bn1 and
        ReLU, then the max pool."""
        x = x.to(self.dtype)
        if runs_folded(self.conv1, False):
            x = conv_relu(self.conv1, x)
        else:
            x = F.relu(self.bn1(self.conv1(x)))
        return F.max_pool2d(x, 3, 2, padding=1)


def build_backbone(cfg: Config, device=None) -> HeatmapBackbone:
    """The backbone that `cfg.BACKBONE` names, in eval mode: 'resnet', a
    `PoseResNet` (RESNET, NUM_JOINTS, COMPUTE_DTYPE), drawn on the host;
    'vitpose', a `vitpose.ViTPose` (VIT, IMAGE_SIZE, NUM_JOINTS,
    COMPUTE_DTYPE), drawn on `device` (None: the host), so that a
    ViTPose-H's 639 M parameters are not drawn on the host to be copied
    or overwritten."""
    if cfg.BACKBONE == "vitpose":
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


def _normalised(backbone: HeatmapBackbone, images: torch.Tensor, color_rgb: bool):
    """uint8 frames decoded BGR and normalised on their device (RGB when
    `color_rgb`); float frames as they are."""
    if images.dtype == torch.uint8:
        return normalize_images_device(images, color_rgb, backbone.image_mean,
                                       backbone.image_std)
    return images


def images_to_features(backbone: PoseResNet, images: torch.Tensor,
                       color_rgb: bool) -> List[torch.Tensor]:
    """Frames (B, V, ih, iw, 3), as `images_to_heatmaps` takes them ->
    the Pose-ResNet's feature levels (`PoseResNet.features`), each (B * V,
    C, h, w), views of one sample adjacent."""
    images = _normalised(backbone, images, color_rgb)
    return backbone.features(images.reshape(-1, *images.shape[2:]))


def images_to_heatmaps(backbone: HeatmapBackbone, images: torch.Tensor,
                       color_rgb: bool) -> torch.Tensor:
    """Frames (B, V, ih, iw, 3) -> heatmaps (B, V, ih/4, iw/4, J) float32:
    uint8 frames are decoded BGR, normalised on their device (RGB when
    `color_rgb`); float frames are taken as normalised.  The backbone (a
    `PoseResNet` or a `vitpose.ViTPose`) runs over the B * V frames at
    once."""
    images = _normalised(backbone, images, color_rgb)
    B, V = images.shape[:2]
    hm = backbone(images.reshape(B * V, *images.shape[2:]))
    return hm.reshape(B, V, *hm.shape[1:])
