"""ViTPose (Xu et al., ViTPose, NeurIPS 2022: the ViT backbone of the
upstream's `mmpose/models/backbones/vit.py` and its
`TopdownHeatmapSimpleHead`) in plain PyTorch: uint8 BGR frames in,
per-joint heatmaps at a quarter of the input's resolution out.

The frames are normalised with the ImageNet mean and deviation (RGB
order where the configuration says COLOR_RGB).  A 16x16 conv at stride
16 and padding 2 embeds the patches; the learned position embedding's
rows 1.. are added with its row 0 added to every token (no class token
enters the sequence).  Each of the blocks is pre-norm:
x + proj(attention(LN1(x))), with qkv biased, the heads' q @ k^T scaled
by the head width's -1/2 and softmaxed over every token, then
x + fc2(GELU(fc1(LN2(x)))) with the exact (erf) GELU; LayerNorm eps 1e-6.
After `last_norm` the tokens go back to (C, Hp, Wp) for the head: two
4x4 stride-2 transposed convolutions to 256 channels, bias-free, each
with BatchNorm (running statistics, eps 1e-5) and ReLU, and a 1x1
convolution to the joints.

Departures from the upstream: the normalisation is done here (the
upstream's data pipeline does it); the position embedding is drawn for
the frame's token grid, where a pretrained one would be interpolated;
drop-path is left out (a training-only regulariser); the attention runs
one view at a time, so that its (heads, N, N) scores fit.

The weights are a state dict keyed as the port's `ViTPose` (the upstream
backbone's names; the head's as the Pose-ResNet's).  `precision` is
`float32`, or the `fp8` control: every operand of a convolution, a
transposed convolution, a dense layer and the two attention products
rounded to fp8 (`reference/precision.py`).
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from .precision import operand_rounding, pin_float32

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LN_EPS = 1e-6
BN_EPS = 1e-5


class ViTPoseReference:
    def __init__(self, weights: Mapping[str, torch.Tensor], color_rgb: bool, heads: int,
                 patch_padding: int = 2, precision: str = "float32"):
        self.w = {k: v.float() for k, v in weights.items()}
        self.color_rgb, self.heads, self.pad = color_rgb, heads, patch_padding
        self.depth = sum(k.startswith("blocks.") and k.endswith(".norm1.weight") for k in self.w)
        self.deconvs = sum(k.startswith("deconv_bn") and k.endswith(".weight") for k in self.w)
        self.q = operand_rounding(precision)
        pin_float32()

    def linear(self, x, name):
        return F.linear(self.q(x), self.q(self.w[f"{name}.weight"]), self.q(self.w[f"{name}.bias"]))

    def norm(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.w[f"{name}.weight"], self.w[f"{name}.bias"],
                            LN_EPS)

    def bn(self, x, name):
        s = (1, -1, 1, 1)
        w = self.w
        return ((x - w[f"{name}.running_mean"].reshape(s))
                / torch.sqrt(w[f"{name}.running_var"].reshape(s) + BN_EPS)
                * w[f"{name}.weight"].reshape(s) + w[f"{name}.bias"].reshape(s))

    def attention(self, x, name):
        N, C = x.shape
        H, q = self.heads, self.q
        qkv = self.linear(x, f"{name}.qkv").reshape(N, 3, H, C // H).permute(1, 2, 0, 3)
        a = (q(qkv[0]) @ q(qkv[1]).transpose(-2, -1)) * (C // H) ** -0.5
        o = q(a.softmax(dim=-1)) @ q(qkv[2])
        return self.linear(o.transpose(0, 1).reshape(N, C), f"{name}.proj")

    def trunk(self, x):
        """One view's tokens (N, C) through the blocks and last_norm."""
        for i in range(self.depth):
            b = f"blocks.{i}"
            x = x + self.attention(self.norm(x, f"{b}.norm1"), f"{b}.attn")
            h = F.gelu(self.linear(self.norm(x, f"{b}.norm2"), f"{b}.mlp.fc1"))
            x = x + self.linear(h, f"{b}.mlp.fc2")
        return self.norm(x, "last_norm")

    @torch.no_grad()
    def __call__(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """(V, H, W, 3) uint8 BGR -> (V, H/4, W/4, J) float32."""
        x = frames_u8.float() / 255.0
        if self.color_rgb:
            x = x.flip(-1)
        mean = torch.tensor(IMAGENET_MEAN, device=x.device)
        std = torch.tensor(IMAGENET_STD, device=x.device)
        x = ((x - mean) / std).permute(0, 3, 1, 2)
        w, q = self.w, self.q
        k = w["patch_embed.proj.weight"].shape[-1]
        x = F.conv2d(q(x), q(w["patch_embed.proj.weight"]), q(w["patch_embed.proj.bias"]),
                     stride=k, padding=self.pad)
        V, C, Hp, Wp = x.shape
        pos = w["pos_embed"]
        x = x.flatten(2).transpose(1, 2) + pos[:, 1:] + pos[:, :1]
        x = torch.stack([self.trunk(t) for t in x])
        x = x.transpose(1, 2).reshape(V, C, Hp, Wp)
        for i in range(1, self.deconvs + 1):
            x = F.conv_transpose2d(q(x), q(w[f"deconv{i}.weight"]), stride=2, padding=1)
            x = F.relu(self.bn(x, f"deconv_bn{i}"))
        x = F.conv2d(q(x), q(w["final.weight"]), q(w["final.bias"]))
        return x.permute(0, 2, 3, 1)
