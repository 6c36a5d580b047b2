"""Pose-ResNet (Simple Baselines, ResNet-50 trunk) in plain PyTorch:
uint8 BGR frames in, per-joint heatmaps at a quarter of the input's
resolution out.

The frames are normalised with the ImageNet mean and deviation (RGB
order where the configuration says COLOR_RGB).  Trunk: a 7x7 stride-2
stem with BatchNorm, ReLU and 3x3 stride-2 max-pool; bottlenecks
(1x1, 3x3 carrying the stride, 1x1 to 4x the width) in stages of 3, 4, 6
and 3 at widths 64, 128, 256 and 512, a projected shortcut on each
stage's first block; then three 4x4 stride-2 transposed convolutions to
256 channels, each with BatchNorm and ReLU, and a 1x1 convolution to the
joints.  The 3x3 and 1x1 stride-2 convolutions pad as "SAME" does (the
output is ceil(n / 2) wide and the larger half of the padding goes
after), the convention of the repo's checkpoints.  BatchNorm uses its
running statistics (eps 1e-5).

The weights are a state dict keyed as the benchmark makes them
(`benchmark.core.weights`).
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from .precision import operand_rounding

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LAYOUT = (3, 4, 6, 3)
WIDTHS = (64, 128, 256, 512)


def same_pad(n: int, k: int, s: int):
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class ResNetReference:
    def __init__(self, weights: Mapping[str, torch.Tensor], color_rgb: bool,
                 precision: str = "float32"):
        self.w = {k: v.float() for k, v in weights.items()}
        self.color_rgb = color_rgb
        self.q = operand_rounding(precision)

    def conv(self, x, name, stride=1, pad=None):
        w = self.w[f"{name}.weight"]
        k = w.shape[-1]
        if pad is None:
            ph, pw = same_pad(x.shape[2], k, stride), same_pad(x.shape[3], k, stride)
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            pad = 0
        b = self.w.get(f"{name}.bias")
        return F.conv2d(self.q(x), self.q(w), None if b is None else self.q(b),
                        stride=stride, padding=pad)

    def bn(self, x, name):
        s = (1, -1, 1, 1)
        w = self.w
        return ((x - w[f"{name}.running_mean"].reshape(s))
                / torch.sqrt(w[f"{name}.running_var"].reshape(s) + 1e-5)
                * w[f"{name}.weight"].reshape(s) + w[f"{name}.bias"].reshape(s))

    def bottleneck(self, x, name, stride, down):
        h = F.relu(self.bn(self.conv(x, f"{name}.conv1"), f"{name}.bn1"))
        h = F.relu(self.bn(self.conv(h, f"{name}.conv2", stride), f"{name}.bn2"))
        h = self.bn(self.conv(h, f"{name}.conv3"), f"{name}.bn3")
        if down:
            x = self.bn(self.conv(x, f"{name}.down_conv", stride), f"{name}.down_bn")
        return F.relu(h + x)

    @torch.no_grad()
    def __call__(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """(V, H, W, 3) uint8 BGR -> (V, H/4, W/4, J) float32."""
        x = frames_u8.float() / 255.0
        if self.color_rgb:
            x = x.flip(-1)
        mean = torch.tensor(IMAGENET_MEAN, device=x.device)
        std = torch.tensor(IMAGENET_STD, device=x.device)
        x = ((x - mean) / std).permute(0, 3, 1, 2)
        x = F.relu(self.bn(self.conv(x, "conv1", 2, pad=3), "bn1"))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for stage, blocks in enumerate(LAYOUT):
            for b in range(blocks):
                stride = (1 if stage == 0 else 2) if b == 0 else 1
                x = self.bottleneck(x, f"layer{stage + 1}_{b}", stride, b == 0)
        for i in (1, 2, 3):
            w = self.w[f"deconv{i}.weight"]
            x = F.conv_transpose2d(self.q(x), self.q(w), stride=2, padding=1)
            x = F.relu(self.bn(x, f"deconv_bn{i}"))
        return self.conv(x, "final", pad=0).permute(0, 2, 3, 1)
