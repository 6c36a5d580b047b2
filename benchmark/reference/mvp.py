"""MvP (Wang, Zhang, Cai, Yan and Feng, "Direct Multi-view Multi-person 3D
Pose Estimation", NeurIPS 2021; sail-sg/mvp
lib/models/multi_view_pose_transformer.py) in plain PyTorch: uint8 frames
and a camera rig in, every instance's pose and score out.

1. Features: the Pose-ResNet-50 of `reference/resnet.py` (its layers, the
   same state dict) to its three transposed convs' outputs, each after its
   BatchNorm and ReLU (strides 16, 8, 4); the output conv is not run.
2. RayConv: the unit world-frame ray R^T ((x - cx) / fx, (y - cy) / fy, 1)
   through each feature pixel's centre ((j + 0.5) iw / W, (i + 0.5) ih /
   H) mapped back through the resize affine into the original image;
   X = [F ; ray] @ rayconv^T, then the values X @ value_proj^T.
3. Queries: (instance h_n + joint g_j), the first d the position p, the
   last d the target t; t += query_adapt(mean of level 0 over views and
   pixels); the first reference y = sigmoid(reference_points(p)).
4. Each decoder layer: t = LN(t + MHA(t + p, t + p, t)), q scaled by
   Dh^-1/2; projective attention: z = t + p, offsets (M, L, P, 2) and
   logits (M, L, P) from z, softmax over (L, P); each view's point u =
   affine(clamp(project(world(y)), -1, max(ow, oh))) / (iw, ih); each tap
   F.grid_sample(value map of the level, head m; align_corners=False,
   zeros) at u + offset / (W_l, H_l); o_v = output_proj(concat over heads
   of the weighted sums); o = fuse(concat over views of o_v); t = LN(t +
   o); t = LN(t + linear2(relu(linear1(t)))); then y = sigmoid(
   inverse_sigmoid(y, 1e-5) + pose_embed_i(t)), the MLP Linear, ReLU,
   Linear, ReLU, Linear.
5. Output: poses world(y) = y * S + C - S / 2 (N, J, 3) mm; score the
   mean over joints of sigmoid(class_embed_last(t)); valid where it is at
   least MIN_SCORE.

Departures from the upstream, as the configuration's `assumed` lists
them: one value projection computed once and read by every layer; query
adaptation as one linear layer on the level-0 mean; the ray ignores lens
distortion; the sampling offsets and weights are shared by the views; the
person score is the mean of the joints' sigmoids; every layer holds its
own pose MLP and class head.

The weights are two state dicts: the backbone's keyed as
`benchmark.core.weights` makes them, MvP's as `core/mvp_weights.py` makes
them.  It imports neither JAX nor either package.  `precision` is
`float32`, or the `fp8` control: every operand of a convolution, a
transposed convolution, a dense layer and an attention matmul rounded to
fp8 (`reference/precision.py`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .precision import operand_rounding, pin_float32
from .resnet import IMAGENET_MEAN, IMAGENET_STD, LAYOUT, ResNetReference
from .voxelpose import project, resize_affine

LN_EPS = 1e-5
SIGMOID_EPS = 1e-5


@dataclass(frozen=True)
class Geometry:
    """The sizes the reference needs, read from a configuration's
    published YAML (`from_config`)."""

    ori_image_size: Tuple[int, int]  # (w, h)
    image_size: Tuple[int, int]
    color_rgb: bool
    space_size: Tuple[float, float, float]
    space_center: Tuple[float, float, float]
    people: int
    joints: int
    threshold: float
    heads: int
    layers: int

    @classmethod
    def from_config(cls, yaml: Mapping) -> "Geometry":
        d, c, m = yaml["DATASET"], yaml["CAPTURE_SPEC"], yaml["MVP"]
        return cls(ori_image_size=tuple(d["ORI_IMAGE_SIZE"]), image_size=tuple(d["IMAGE_SIZE"]),
                   color_rgb=bool(d["COLOR_RGB"]),
                   space_size=tuple(map(float, c["SPACE_SIZE"])),
                   space_center=tuple(map(float, c["SPACE_CENTER"])),
                   people=int(c["MAX_PEOPLE"]), joints=int(d["NUM_JOINTS"]),
                   threshold=float(c["MIN_SCORE"]), heads=int(m["NUM_HEADS"]),
                   layers=int(m["DEC_LAYERS"]))


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=SIGMOID_EPS) / (1.0 - x).clamp(min=SIGMOID_EPS))


class MvPReference:
    """MvP of one configuration and two state dicts on `device`."""

    def __init__(self, geom: Geometry, backbone: Mapping[str, torch.Tensor],
                 state: Mapping[str, torch.Tensor], device, precision: str = "float32"):
        pin_float32()
        self.geom, self.device = geom, torch.device(device)
        self.q = operand_rounding(precision)
        self.backbone = ResNetReference({k: torch.as_tensor(v).to(self.device)
                                         for k, v in backbone.items()}, geom.color_rgb, precision)
        self.w = {k: torch.as_tensor(v).float().to(self.device) for k, v in state.items()}
        self.affine = resize_affine(geom.ori_image_size, geom.image_size)

    def dense(self, x: torch.Tensor, name: str) -> torch.Tensor:
        w, b = self.w[f"{name}.weight"], self.w[f"{name}.bias"]
        return self.q(x) @ self.q(w).t() + self.q(b)

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)

    def layer_norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.w[f"{name}.weight"], self.w[f"{name}.bias"],
                            LN_EPS)

    def features(self, frames_u8: torch.Tensor) -> List[torch.Tensor]:
        """(V, H, W, 3) uint8 BGR -> the transposed convs' outputs, (V, C,
        h, w) float32 each, coarsest first."""
        r = self.backbone
        x = frames_u8.float() / 255.0
        if r.color_rgb:
            x = x.flip(-1)
        mean = torch.tensor(IMAGENET_MEAN, device=x.device)
        std = torch.tensor(IMAGENET_STD, device=x.device)
        x = ((x - mean) / std).permute(0, 3, 1, 2)
        x = F.relu(r.bn(r.conv(x, "conv1", 2, pad=3), "bn1"))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for stage, blocks in enumerate(LAYOUT):
            for b in range(blocks):
                stride = (1 if stage == 0 else 2) if b == 0 else 1
                x = r.bottleneck(x, f"layer{stage + 1}_{b}", stride, b == 0)
        out = []
        for i in (1, 2, 3):
            x = F.conv_transpose2d(r.q(x), r.q(r.w[f"deconv{i}.weight"]), stride=2, padding=1)
            x = F.relu(r.bn(x, f"deconv_bn{i}"))
            out.append(x)
        return out

    def rays(self, cams: torch.Tensor, H: int, W: int) -> torch.Tensor:
        """(V, H, W, 3) unit world-frame rays of an H x W level's pixel
        centres."""
        iw, ih = self.geom.image_size
        a = np.asarray(self.affine, np.float64)
        xs, ys = np.meshgrid((np.arange(W) + 0.5) * iw / W, (np.arange(H) + 0.5) * ih / H)
        q = np.stack([xs, ys], -1) - a[:, 2]
        ori = torch.as_tensor(q @ np.linalg.inv(a[:, :2]).T, dtype=torch.float32,
                              device=cams.device)  # (H, W, 2) original-image pixels
        R = cams[:, 0:9].reshape(-1, 3, 3)
        d = torch.stack([(ori[..., 0] - cams[:, 14, None, None]) / cams[:, 12, None, None],
                         (ori[..., 1] - cams[:, 15, None, None]) / cams[:, 13, None, None],
                         torch.ones((cams.shape[0], H, W), device=cams.device)], -1)
        ray = (d[..., :, None] * R[:, None, None]).sum(-2)  # R^T d, no matmul: no TF32
        return ray / ray.norm(dim=-1, keepdim=True)

    def world(self, y: torch.Tensor) -> torch.Tensor:
        g = self.geom
        size = torch.tensor(g.space_size, device=y.device)
        centre = torch.tensor(g.space_center, device=y.device)
        return y * size + centre - size / 2.0

    def input_uv(self, y: torch.Tensor, cams: torch.Tensor) -> torch.Tensor:
        """Reference points (Q, 3) -> each view's normalised input position
        (V, Q, 2)."""
        g = self.geom
        px = project(self.world(y), cams).clamp(-1.0, float(max(g.ori_image_size)))
        A = torch.as_tensor(self.affine, dtype=torch.float32, device=y.device)
        x = px[..., 0] * A[0, 0] + px[..., 1] * A[0, 1] + A[0, 2]
        yy = px[..., 0] * A[1, 0] + px[..., 1] * A[1, 1] + A[1, 2]
        return torch.stack([x / g.image_size[0], yy / g.image_size[1]], -1)

    def self_attention(self, t, p, name):
        Q, d = t.shape
        H = self.geom.heads
        w, b = self.w[f"{name}.in_proj.weight"], self.w[f"{name}.in_proj.bias"]
        q = (self.q(t + p) @ self.q(w[:d]).t() + self.q(b[:d])).view(Q, H, -1).transpose(0, 1)
        k = (self.q(t + p) @ self.q(w[d:2 * d]).t() + self.q(b[d:2 * d])).view(Q, H, -1)
        v = (self.q(t) @ self.q(w[2 * d:]).t() + self.q(b[2 * d:])).view(Q, H, -1).transpose(0, 1)
        a = torch.softmax(self.matmul(q / math.sqrt(d // H), k.permute(1, 2, 0)), dim=-1)
        return self.dense(self.matmul(a, v).transpose(0, 1).reshape(Q, d), f"{name}.out_proj")

    def projective_attention(self, z, y, values, cams, name):
        """(V, Q, d): each view's weighted taps of every head, before
        output_proj."""
        Q, d = z.shape
        V, M, L = cams.shape[0], self.geom.heads, len(values)
        off = self.dense(z, f"{name}.sampling_offsets").view(Q, M, L, -1, 2)
        P = off.shape[3]
        a = torch.softmax(self.dense(z, f"{name}.attention_weights").view(Q, M, L * P), -1)
        a = a.view(Q, M, L, P)
        uv = self.input_uv(y, cams)  # (V, Q, 2)
        out = torch.zeros((V, M, d // M, Q), device=z.device)
        for level, val in enumerate(values):  # (V, H, W, d)
            H, W = val.shape[1:3]
            loc = uv[:, :, None, None] + off[None, :, :, level] / torch.tensor(
                [float(W), float(H)], device=z.device)  # (V, Q, M, P, 2)
            grid = (2.0 * loc - 1.0).permute(0, 2, 1, 3, 4).reshape(V * M, Q, P, 2)
            maps = val.reshape(V, H, W, M, d // M).permute(0, 3, 4, 1, 2).reshape(V * M, -1, H, W)
            s = F.grid_sample(maps, grid, mode="bilinear", padding_mode="zeros",
                              align_corners=False).reshape(V, M, d // M, Q, P)
            out += (s * a[:, :, level].permute(1, 0, 2)[None, :, None]).sum(-1)
        return out.permute(0, 3, 1, 2).reshape(V, Q, d)

    @torch.no_grad()
    def __call__(self, frames_u8: torch.Tensor, cams: torch.Tensor) -> Dict[str, torch.Tensor]:
        """frames (V, H, W, 3) uint8 and cams (V, 21) float32 on the
        device -> per instance slot (N): 'poses' (N, J, 3) mm, 'scores'
        (N,), 'valid' (N,) bool; and 'trail' (layers + 1, N, J, 3), the
        joints of the first reference points and after each layer."""
        g = self.geom
        feats = self.features(frames_u8)
        values = []
        for f in feats:
            V, C, H, W = f.shape
            x = torch.cat([f.permute(0, 2, 3, 1), self.rays(cams, H, W)], -1)
            values.append(self.dense(self.dense(x, "rayconv"), "value_proj"))
        e = self.w["instance_embed"][:, None] + self.w["joint_embed"][None]
        e = e.reshape(g.people * g.joints, -1)
        d = e.shape[1] // 2
        p, t = e[:, :d], e[:, d:]
        t = t + self.dense(feats[0].mean(dim=(0, 2, 3)), "query_adapt")
        y = torch.sigmoid(self.dense(p, "reference_points"))
        ys = [y]
        for i in range(g.layers):
            n = f"layers.{i}"
            t = self.layer_norm(t + self.self_attention(t, p, n), f"{n}.norm1")
            s = self.projective_attention(t + p, y, values, cams, n)
            o = self.dense(s, f"{n}.output_proj").transpose(0, 1).reshape(t.shape[0], -1)
            t = self.layer_norm(t + self.dense(o, f"{n}.fuse"), f"{n}.norm2")
            h = F.relu(self.dense(t, f"{n}.linear1"))
            t = self.layer_norm(t + self.dense(h, f"{n}.linear2"), f"{n}.norm3")
            h = F.relu(self.dense(t, f"pose_embed.{i}.layers.0"))
            h = F.relu(self.dense(h, f"pose_embed.{i}.layers.1"))
            y = torch.sigmoid(inverse_sigmoid(y) + self.dense(h, f"pose_embed.{i}.layers.2"))
            ys.append(y)
        c = self.dense(t, f"class_embed.{g.layers - 1}")
        scores = torch.sigmoid(c).view(g.people, g.joints).mean(-1)
        return {"poses": self.world(y).view(g.people, g.joints, 3), "scores": scores,
                "valid": scores >= g.threshold,
                "trail": self.world(torch.stack(ys)).view(-1, g.people, g.joints, 3)}
