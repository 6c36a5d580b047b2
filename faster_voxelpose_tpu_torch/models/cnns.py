"""Task heads: P2PNet (plane->pose), CenterNet (BEV center+bbox), C2CNet
(1D height), WeightNet (plane-fusion weights) — counterparts of
`faster_voxelpose_tpu/models/cnns.py` (reference cnns_2d.py:115-187,
cnns_1d.py:112-143, weight_net.py:48-89), channels-first inside.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import BatchNorm, Conv, Dense, EncoderDecoder, UNetFront, scaled


class P2PNet(nn.Module):
    """Plane-to-pose U-Net: (N, J, 64, 64) plane projections -> per-joint
    plane heatmaps (N, J_out, 64, 64), float32."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32, width=1.0):
        super().__init__()
        self.front = UNetFront(cin, 2, dtype, width)
        self.encdec = EncoderDecoder(2, dtype, width)
        self.output = Conv(scaled(32, width), cout, 1, 2, dtype)

    def forward(self, x):
        return self.output(self.encdec(self.front(x))).float()


class CenterNet(nn.Module):
    """BEV detection head: cube (B, X, Y, Z, J) -> z max-projection ->
    U-Net -> center heatmap (B, 1, X, Y) and bbox size (B, 2, X, Y)."""

    def __init__(self, cin: int, head_conv: int = 32, dtype=torch.float32, width=1.0):
        super().__init__()
        head = scaled(head_conv, width)
        c32 = scaled(32, width)
        self.dtype = dtype
        self.front = UNetFront(cin, 2, dtype, width)
        self.encdec = EncoderDecoder(2, dtype, width)
        self.hm_conv = Conv(c32, head, 3, 2, dtype)
        self.hm_out = Conv(head, 1, 1, 2, dtype)
        self.size_conv = Conv(c32, head, 3, 2, dtype)
        self.size_out = Conv(head, 2, 1, 2, dtype)

    def forward(self, cube):
        x = cube.amax(dim=3).permute(0, 3, 1, 2).to(self.dtype)
        x = self.encdec(self.front(x))
        hm = self.hm_out(F.relu(self.hm_conv(x)))
        size = self.size_out(F.relu(self.size_conv(x)))
        return hm.float(), size.float()


class C2CNet(nn.Module):
    """1D height net: z-columns (N, J, Z) -> (N, Z) float32."""

    def __init__(self, cin: int, dtype=torch.float32, width=1.0):
        super().__init__()
        self.front = UNetFront(cin, 1, dtype, width)
        self.encdec = EncoderDecoder(1, dtype, width)
        self.output = Conv(scaled(32, width), 1, 1, 1, dtype)

    def forward(self, x):
        return self.output(self.encdec(self.front(x)))[:, 0].float()


class WeightNet(nn.Module):
    """Per joint-plane fusion weight in (0, 1): (M, J, H, W) plane
    features -> conv + BN + maxpool + ReLU (the reference's order) ->
    global average pool -> 2-layer MLP -> sigmoid, (M, J, 1)."""

    def __init__(self, feat_channels=32, hidden_channels=64, dtype=torch.float32):
        super().__init__()
        self.feat_conv = Conv(1, feat_channels, 3, 2, dtype)
        self.feat_bn = BatchNorm(feat_channels, dtype)
        self.fc1 = Dense(feat_channels, hidden_channels, dtype)
        self.fc2 = Dense(hidden_channels, 1, dtype)

    def forward(self, x):
        M, J, H, W = x.shape
        x = self.feat_bn(self.feat_conv(x.reshape(M * J, 1, H, W)))
        x = F.relu(F.max_pool2d(x, 2))
        x = x.mean(dim=(2, 3))
        x = self.fc2(F.relu(self.fc1(x)))
        return torch.sigmoid(x.float()).reshape(M, J, 1)
