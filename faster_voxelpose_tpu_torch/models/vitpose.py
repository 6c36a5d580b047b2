"""ViTPose 2D heatmap backbone (Xu et al., ViTPose, NeurIPS 2022; the
upstream's `mmpose/models/backbones/vit.py` with its
`TopdownHeatmapSimpleHead`): a plain vision transformer over 16x16
patches, two 4x4 stride-2 transposed convs and a per-joint 1x1 conv,
heatmaps at a quarter of the input's resolution.  The JAX package has no
counterpart: it runs only the Pose-ResNet.

- Patch embedding: a p x p conv at stride p and padding 2 (p = 16), 3 ->
  C channels, the tokens (Hp x Wp) in row order.  The padding, LayerNorm's
  eps, the head's 4x4 kernels and 1x1 output conv are the upstream's for
  every size it publishes, so they are constants here.
- Position embedding: a learned (1, N + 1, C); its entry 0 is added to
  every token, as `x + pos_embed[:, 1:] + pos_embed[:, :1]` (no class
  token enters the sequence).
- DEPTH pre-norm blocks: `x += proj(attn(LN1(x)))` with qkv biased and
  NUM_HEADS heads of C / NUM_HEADS, scale its -1/2, softmax over all
  tokens (`F.scaled_dot_product_attention`); `x += fc2(GELU(fc1(LN2(x))))`,
  fc1 of MLP_RATIO x C, the exact (erf) GELU.  LayerNorm eps 1e-6.
  Drop-path is a training-only regulariser and the identity here.
- `last_norm`, the tokens back to (C, Hp, Wp), then the head the
  Pose-ResNet ends in too (`blocks.HeatmapBackbone`): each transposed
  conv (bias-free) with BatchNorm and ReLU, and the output conv with bias,
  its result float32 (`blocks.Conv`, `float32_out`).

Parameter names follow the upstream backbone's (`patch_embed.proj`,
`pos_embed`, `blocks.<i>.attn.qkv`, `blocks.<i>.mlp.fc1`, `last_norm`);
the head's are the Pose-ResNet's (`deconv1`, `deconv_bn1`, `final`).

Everything runs in the compute dtype: matmuls and convs on bf16 operands
with float32 sums, LayerNorm and the softmax with float32 statistics
inside torch's bf16 kernels, the residual stream in bf16.  For serving,
`FoldedModule.fold()` (label "vitpose") prepares every weight once in
that dtype (`blocks.fold_layers`: the trunk's torch layers cast, the
head's BatchNorms folded into its transposed convs; the two position
terms summed by `fold_extra`) into non-persistent buffers, so that no
forward casts the parameters; refolds follow `blocks.FoldedModule`.
Training, and a module never folded, cast the float32 parameters in each
forward.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from ..utils import profiling
from .blocks import HeatmapBackbone
from .faster_voxelpose import DTYPES

# (module) -> (weight, bias) in the compute dtype
Weights = Callable[[nn.Module], Tuple[torch.Tensor, Optional[torch.Tensor]]]
PATCH_PADDING = 2
LN_EPS = 1e-6


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(3, dim, patch, patch, PATCH_PADDING)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class Block(nn.Module):
    """One pre-norm transformer block; its submodules hold the parameters,
    and `forward` takes their weights from `w`."""

    def __init__(self, dim: int, heads: int, hidden: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, hidden)

    def forward(self, x: torch.Tensor, w: Weights) -> torch.Tensor:
        B, N, C = x.shape
        H = self.attn.heads
        h = F.layer_norm(x, (C,), *w(self.norm1), LN_EPS)
        q, k, v = F.linear(h, *w(self.attn.qkv)).view(B, N, 3, H, C // H).permute(
            2, 0, 3, 1, 4).unbind(0)
        a = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(B, N, C)
        x = x + F.linear(a, *w(self.attn.proj))
        h = F.layer_norm(x, (C,), *w(self.norm2), LN_EPS)
        return x + F.linear(F.gelu(F.linear(h, *w(self.mlp.fc1))), *w(self.mlp.fc2))


class ViTPose(HeatmapBackbone):
    """ViTPose in inference: images (B, H, W, 3), normalised, any float
    dtype -> heatmaps (B, H/4, W/4, J) float32, at the frame size
    `image_size` (W, H) that the position embedding is drawn for.

    A fresh module is a random backbone drawn from torch's generator, on
    the device of the factory functions (`torch.device(...)` as a
    context): linear weights and the position embedding truncated-normal
    of std 0.02, biases 0, LayerNorm at identity, the patch conv as
    `nn.Conv2d` draws it (the upstream's inits); the head as the
    Pose-ResNet's."""

    FOLD_LABEL = "vitpose"

    def __init__(self, image_size: Sequence[int] = (192, 256), num_joints: int = 17,
                 patch_size: int = 16, embed_dim: int = 1280, depth: int = 32,
                 num_heads: int = 16, mlp_ratio: int = 4,
                 deconv_filters: Sequence[int] = (256, 256), dtype: torch.dtype = torch.float32):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"width {embed_dim} is not a multiple of {num_heads} heads")
        self.dtype = dtype
        iw, ih = image_size
        self.grid = (ih // patch_size, iw // patch_size)  # the upstream's count of patches
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, self.grid[0] * self.grid[1] + 1, embed_dim))
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, mlp_ratio * embed_dim)
                                    for _ in range(depth))
        self.last_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.build_head(embed_dim, deconv_filters, False, num_joints, 1, dtype)
        with torch.no_grad():
            nn.init.trunc_normal_(self.pos_embed, std=0.02)
            for m in self.blocks.modules():
                if isinstance(m, nn.Linear):
                    nn.init.trunc_normal_(m.weight, std=0.02)
                    nn.init.zeros_(m.bias)

    def fold_extra(self) -> List[torch.Tensor]:
        """`pos_embed[:, 1:] + pos_embed[:, :1]` in the compute dtype as
        `folded_pos`, beside the layers' folded weights."""
        pos = (self.pos_embed[:, 1:] + self.pos_embed[:, :1]).to(self.dtype)
        if "folded_pos" in self._buffers:
            self.folded_pos.copy_(pos)
        else:
            self.register_buffer("folded_pos", pos, persistent=False)
        return [self.pos_embed]

    def _cast(self, m: nn.Module) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        dt = self.dtype
        return m.weight.to(dt), None if m.bias is None else m.bias.to(dt)

    @staticmethod
    def _folded(m: nn.Module) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        return m.folded_weight, m.folded_bias

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)
        served = self.serving(x)
        w = self._folded if served else self._cast
        pe = self.patch_embed
        x = F.conv2d(x.to(self.dtype), *w(pe.proj), stride=pe.patch, padding=PATCH_PADDING)
        B, C, Hp, Wp = x.shape
        if (Hp, Wp) != self.grid:
            raise ValueError(f"frames of {Hp}x{Wp} tokens; the position embedding is drawn "
                             f"for {self.grid[0]}x{self.grid[1]}")
        pos = self.folded_pos if served else (self.pos_embed[:, 1:] + self.pos_embed[:, :1]).to(
            self.dtype)
        x = x.flatten(2).transpose(1, 2).contiguous() + pos
        profiling.mark("vit_patch")
        for blk in self.blocks:
            x = blk(x, w)
        profiling.mark("vit_blocks")
        x = F.layer_norm(x, (C,), *w(self.last_norm), LN_EPS)
        x = x.transpose(1, 2).reshape(B, C, Hp, Wp)  # a channels-last view
        return self.head(x)


def build_vitpose(cfg: Config, device=None) -> ViTPose:
    """The ViTPose of `cfg` (VIT, IMAGE_SIZE, NUM_JOINTS, COMPUTE_DTYPE) in
    eval mode, its parameters drawn on `device` (None: the default)."""
    v = cfg.VIT
    with contextlib.nullcontext() if device is None else torch.device(device):
        return ViTPose(
            image_size=cfg.DATASET.IMAGE_SIZE, num_joints=cfg.DATASET.NUM_JOINTS,
            patch_size=v.PATCH_SIZE, embed_dim=v.EMBED_DIM, depth=v.DEPTH,
            num_heads=v.NUM_HEADS, mlp_ratio=v.MLP_RATIO,
            deconv_filters=tuple(v.NUM_DECONV_FILTERS), dtype=DTYPES[cfg.NETWORK.COMPUTE_DTYPE],
        ).eval()
