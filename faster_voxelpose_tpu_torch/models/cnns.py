"""Task heads: P2PNet (plane->pose), CenterNet (BEV center+bbox), C2CNet
(1D height), WeightNet (plane-fusion weights) — counterparts of
`faster_voxelpose_tpu/models/cnns.py` (reference cnns_2d.py:115-187,
cnns_1d.py:112-143, weight_net.py:48-89), channels-first inside.  Each
takes `train` and passes it to its layers.  Each head's last layer,
whose result the JAX package casts to float32 at once, returns its
float32 sums of the rounded operands (`blocks.Conv`, `float32_out`): one
rule for all five, folded or not (`blocks.FoldedModule`; the model folds
them, `FoldedModule.fold`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import (BatchNorm, Conv, Dense, EncoderDecoder, UNetFront, conv_relu, runs_folded,
                     scaled)


class P2PNet(nn.Module):
    """Plane-to-pose U-Net: (N, J, 64, 64) plane projections -> per-joint
    plane heatmaps (N, J_out, 64, 64), float32."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32, width=1.0):
        super().__init__()
        self.front = UNetFront(cin, 2, dtype, width)
        self.encdec = EncoderDecoder(2, dtype, width)
        self.output = Conv(scaled(32, width), cout, 1, 2, dtype, float32_out=True)

    def forward(self, x, train: bool = False):
        return self.output(self.encdec(self.front(x, train), train), train).float()


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
        # The centre heatmap is where the float32 sums matter.  Rounded to
        # bf16, neighbouring cells of a flat peak tie, the max-pool
        # equality NMS keeps both, and one person is proposed twice: on the
        # held-out synthetic scenes that cost 0.03 AP at every threshold
        # against float32 and against the snapshot's own bf16 record, made
        # on a TPU.  The JAX package on the CPU does round here; that the
        # TPU does not is inferred from the record, not read from XLA.
        self.hm_out = Conv(head, 1, 1, 2, dtype, float32_out=True)
        self.size_conv = Conv(c32, head, 3, 2, dtype)
        self.size_out = Conv(head, 2, 1, 2, dtype, float32_out=True)

    def forward(self, cube, train: bool = False):
        x = cube.amax(dim=3).permute(0, 3, 1, 2).to(self.dtype)
        x = self.encdec(self.front(x, train), train)
        return self._head(self.hm_conv, self.hm_out, x, train), \
            self._head(self.size_conv, self.size_out, x, train)

    @staticmethod
    def _head(conv: Conv, out: Conv, x, train: bool):
        """out(relu(conv(x))) in float32, conv and its ReLU one cuDNN call
        where folded."""
        h = conv_relu(conv, x) if runs_folded(conv, train) else F.relu(conv(x, train))
        return out(h, train).float()


class C2CNet(nn.Module):
    """1D height net: z-columns (N, J, Z) -> (N, Z) float32."""

    def __init__(self, cin: int, dtype=torch.float32, width=1.0):
        super().__init__()
        self.front = UNetFront(cin, 1, dtype, width)
        self.encdec = EncoderDecoder(1, dtype, width)
        self.output = Conv(scaled(32, width), 1, 1, 1, dtype, float32_out=True)

    def forward(self, x, train: bool = False):
        return self.output(self.encdec(self.front(x, train), train), train)[:, 0].float()


class WeightNet(nn.Module):
    """Per joint-plane fusion weight in (0, 1): (M, J, H, W) plane
    features -> conv + BN + maxpool + ReLU (the reference's order) ->
    global average pool -> 2-layer MLP -> sigmoid, (M, J, 1).  Folded, the
    conv, its bias and the ReLU are one cuDNN call before the max pool:
    the same values, since ReLU is monotone and so commutes with max."""

    FOLD_PAIRS = (("feat_conv", "feat_bn"),)

    def __init__(self, feat_channels=32, hidden_channels=64, dtype=torch.float32):
        super().__init__()
        self.feat_conv = Conv(1, feat_channels, 3, 2, dtype)
        self.feat_bn = BatchNorm(feat_channels, dtype)
        self.fc1 = Dense(feat_channels, hidden_channels, dtype)
        self.fc2 = Dense(hidden_channels, 1, dtype, float32_out=True)

    def forward(self, x, train: bool = False):
        M, J, H, W = x.shape
        x, conv = x.reshape(M * J, 1, H, W), self.feat_conv
        if runs_folded(conv, train):
            x = F.max_pool2d(conv_relu(conv, x.to(conv.dtype)), 2)
        else:
            x = F.relu(F.max_pool2d(self.feat_bn(conv(x, train), train), 2))
        x = x.mean(dim=(2, 3))
        x = self.fc2(F.relu(self.fc1(x, train)), train)
        return torch.sigmoid(x.float()).reshape(M, J, 1)
