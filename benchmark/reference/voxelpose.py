"""VoxelPose (Tu, Wang and Zeng, ECCV 2020; voxelpose-pytorch
lib/models/{v2v_net, cuboid_proposal_net, pose_regression_net,
project_layer}.py) in plain PyTorch: heatmaps and a camera rig in, every
proposal's pose out.

1. ProjectLayer: each grid point is projected into every view (pinhole
   with radial and tangential distortion); it counts in a view where the
   projection lies inside the original image (`bounding`); the pixel is
   clamped to [-1, max(w, h)], moved into the heatmap frame and sampled
   with grid_sample (bilinear, zeros, align_corners); the samples of the
   views it counts in are summed, divided by their count plus 1e-6, and
   clamped to [0, 1].  Grids are linspace(-S/2, S/2, n) + centre per
   axis, x slowest.
2. CPN: the whole space's cube, V2VNet(J, 1) to the root cube, NMS (keep
   the voxels equal to their 3x3x3 max-pool), the top K of the flattened
   cube (ties to the lower index); each index to world mm as
   index / (n - 1) * S + centre - S / 2; valid where its value passes
   THRESHOLD.
3. PRN: per proposal the 64^3 cube about its centre, V2VNet(J, J),
   softmax of BETA x over the cube's voxels, the sum of the weights times
   the grid's world coordinates.  Every slot runs; the comparison reads
   the valid ones.

V2VNet: a 7^3 conv to 16, BN, ReLU; Res3DBlock(16, 32); the
encoder-decoder (skip_res1; max-pool 2, encoder_res1 to 64; skip_res2;
max-pool 2, encoder_res2 to 128; mid_res; decoder_res2; ConvTranspose3d
k2 s2 to 64, BN, ReLU; + skip2; decoder_res1; the same to 32; + skip1);
a 1^3 conv to the outputs.  Res3DBlock(cin, cout) is
ReLU(BN(conv3(ReLU(BN(conv3 x)))) + skip), the skip a 1^3 conv + BN where
the channels change.  BatchNorm uses its running statistics, eps 1e-5.

The weights are a state dict keyed as the port's `VoxelPoseNet`
(`cpn.` and `prn.`, then `front.front_basic`, `front.front_res`,
`encdec.<block>`, `output`; convs `conv1`, `bn1`, `conv2`, `bn2`,
`skip_conv`, `skip_bn`, upsamples `deconv`, `bn`), in PyTorch's layouts.
It imports neither JAX nor either package.  `precision` is `float32`, or
the `fp8` control: every operand of a convolution and a transposed
convolution rounded to fp8 (`reference/precision.py`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .precision import operand_rounding, pin_float32

BN_EPS = 1e-5


@dataclass(frozen=True)
class Geometry:
    """The sizes the reference needs, read from a configuration's
    published YAML (`from_config`)."""

    ori_image_size: Tuple[int, int]  # (w, h)
    image_size: Tuple[int, int]
    heatmap_size: Tuple[int, int]
    space_size: Tuple[float, float, float]
    space_center: Tuple[float, float, float]
    voxels: Tuple[int, int, int]
    max_people: int
    threshold: float
    cube_size: Tuple[float, float, float]
    cube_voxels: Tuple[int, int, int]
    beta: float

    @classmethod
    def from_config(cls, yaml: Mapping) -> "Geometry":
        d, c, i = yaml["DATASET"], yaml["CAPTURE_SPEC"], yaml["INDIVIDUAL_SPEC"]
        return cls(
            ori_image_size=tuple(d["ORI_IMAGE_SIZE"]), image_size=tuple(d["IMAGE_SIZE"]),
            heatmap_size=tuple(d["HEATMAP_SIZE"]), space_size=tuple(map(float, c["SPACE_SIZE"])),
            space_center=tuple(map(float, c["SPACE_CENTER"])), voxels=tuple(c["VOXELS_PER_AXIS"]),
            max_people=int(c["MAX_PEOPLE"]), threshold=float(c["MIN_SCORE"]),
            cube_size=tuple(map(float, i["SPACE_SIZE"])), cube_voxels=tuple(i["VOXELS_PER_AXIS"]),
            beta=float(yaml["NETWORK"]["BETA"]))


def resize_affine(ori, out) -> np.ndarray:
    """The 2x3 affine from the original image onto the network input: the
    image padded to the input's aspect ratio about its centre, then
    scaled uniformly."""
    w, h = float(ori[0]), float(ori[1])
    ow, oh = float(out[0]), float(out[1])
    if w / ow < h / oh:
        pad_w, pad_h = h / oh * ow, h
    else:
        pad_w, pad_h = w, w / ow * oh
    k = ow / pad_w if pad_w >= pad_h else oh / pad_h
    return np.array([[k, 0.0, ow / 2 - k * w / 2], [0.0, k, oh / 2 - k * h / 2]])


def project(points: torch.Tensor, cams: torch.Tensor) -> torch.Tensor:
    """World points (N, 3) mm -> image pixels (V, N, 2) for packed cameras
    (V, 21): R (9, world->camera), T (3, camera centre), fx, fy, cx, cy,
    k1..k3, p1, p2."""
    R = cams[:, 0:9].reshape(-1, 3, 3)
    T = cams[:, 9:12]
    rel = points[None] - T[:, None]  # (V, N, 3)
    cam = (rel[..., None, :] * R[:, None]).sum(-1)  # (V, N, 3), no matmul: no TF32
    x = cam[..., 0] / (cam[..., 2] + 1e-5)
    y = cam[..., 1] / (cam[..., 2] + 1e-5)
    k1, k2, k3, p1, p2 = (cams[:, i, None] for i in range(16, 21))
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    u = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    v = y * radial + 2 * p2 * x * y + p1 * (r2 + 2 * y * y)
    return torch.stack([u * cams[:, 12, None] + cams[:, 14, None],
                        v * cams[:, 13, None] + cams[:, 15, None]], dim=-1)


def project_layer(geom: Geometry, heatmaps: torch.Tensor, cams: torch.Tensor,
                  points: torch.Tensor) -> torch.Tensor:
    """heatmaps (V, H, W, J), world points (N, 3) -> (N, J): the samples
    of the views whose original image holds the point, over their count
    plus 1e-6, clamped to [0, 1]."""
    px = project(points, cams)
    ow, oh = (float(v) for v in geom.ori_image_size)
    bounding = ((px[..., 0] >= 0) & (px[..., 1] >= 0) & (px[..., 0] < ow)
                & (px[..., 1] < oh)).float()  # (V, N)
    px = px.clamp(-1.0, max(ow, oh))
    A = torch.as_tensor(resize_affine(geom.ori_image_size, geom.image_size),
                        dtype=torch.float32, device=points.device)
    x = px[..., 0] * A[0, 0] + px[..., 1] * A[0, 1] + A[0, 2]
    y = px[..., 0] * A[1, 0] + px[..., 1] * A[1, 1] + A[1, 2]
    (w, h), (iw, ih) = geom.heatmap_size, geom.image_size
    gx = x * w / iw / (w - 1) * 2 - 1
    gy = y * h / ih / (h - 1) * 2 - 1
    grid = torch.stack([gx, gy], dim=-1).clamp(-1.1, 1.1)[:, None]  # (V, 1, N, 2)
    vals = F.grid_sample(heatmaps.permute(0, 3, 1, 2), grid, mode="bilinear",
                         padding_mode="zeros", align_corners=True)[:, :, 0]  # (V, J, N)
    cube = (vals * bounding[:, None]).sum(0) / (bounding.sum(0) + 1e-6)
    return cube.clamp(0.0, 1.0).t()


def grid_points(size, center, voxels, device) -> torch.Tensor:
    """Grid points (X*Y*Z, 3): linspace(-S/2, S/2, n) + centre per axis,
    x slowest, in float32."""
    axes = [torch.linspace(-s / 2, s / 2, n, device=device) + c
            for s, c, n in zip(size, center, voxels)]
    mesh = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([m.reshape(-1) for m in mesh], -1)


class Weights:
    """A state dict's tensors as float32 on the device, and the layers
    that read them."""

    def __init__(self, state: Mapping[str, torch.Tensor], device, round_fn):
        self.w = {k: torch.as_tensor(v).float().to(device) for k, v in state.items()}
        self.q = round_fn

    def conv(self, x, path, pad):
        w, b = self.w[f"{path}.weight"], self.w[f"{path}.bias"]
        return F.conv3d(self.q(x), self.q(w), self.q(b), padding=pad)

    def deconv(self, x, path):
        w, b = self.w[f"{path}.weight"], self.w[f"{path}.bias"]
        return F.conv_transpose3d(self.q(x), self.q(w), self.q(b), stride=2)

    def bn(self, x, path):
        s = (1, -1, 1, 1, 1)
        w = self.w
        return ((x - w[f"{path}.running_mean"].reshape(s))
                / torch.sqrt(w[f"{path}.running_var"].reshape(s) + BN_EPS)
                * w[f"{path}.weight"].reshape(s) + w[f"{path}.bias"].reshape(s))


def res_block(p: Weights, x, path):
    h = F.relu(p.bn(p.conv(x, f"{path}.conv1", 1), f"{path}.bn1"))
    h = p.bn(p.conv(h, f"{path}.conv2", 1), f"{path}.bn2")
    if f"{path}.skip_conv.weight" in p.w:
        x = p.bn(p.conv(x, f"{path}.skip_conv", 0), f"{path}.skip_bn")
    return F.relu(h + x)


def up_block(p: Weights, x, path):
    return F.relu(p.bn(p.deconv(x, f"{path}.deconv"), f"{path}.bn"))


def v2v(p: Weights, x, path):
    """V2VNet: (N, cin, X, Y, Z) -> (N, cout, X, Y, Z)."""
    x = F.relu(p.bn(p.conv(x, f"{path}.front.front_basic.conv", 3),
                    f"{path}.front.front_basic.bn"))
    x = res_block(p, x, f"{path}.front.front_res")
    e = f"{path}.encdec"
    skip1 = res_block(p, x, f"{e}.skip_res1")
    x = res_block(p, F.max_pool3d(x, 2), f"{e}.encoder_res1")
    skip2 = res_block(p, x, f"{e}.skip_res2")
    x = res_block(p, F.max_pool3d(x, 2), f"{e}.encoder_res2")
    x = res_block(p, x, f"{e}.mid_res")
    x = up_block(p, res_block(p, x, f"{e}.decoder_res2"), f"{e}.decoder_upsample2") + skip2
    x = up_block(p, res_block(p, x, f"{e}.decoder_res1"), f"{e}.decoder_upsample1") + skip1
    return p.conv(x, f"{path}.output", 0)


def nms_topk(cube: torch.Tensor, k: int):
    """A (X, Y, Z) cube's voxels equal to their 3x3x3 max-pool, the k
    largest (ties to the lower flat index): values and flat indices."""
    pooled = F.max_pool3d(cube[None, None], 3, stride=1, padding=1)[0, 0]
    flat = (cube * (cube == pooled).float()).reshape(-1)
    values, order = torch.sort(flat, descending=True, stable=True)
    return values[:k], order[:k]


class VoxelPoseReference:
    """VoxelPose of one configuration and state dict on `device`."""

    def __init__(self, geom: Geometry, state: Mapping[str, torch.Tensor], device,
                 precision: str = "float32"):
        self.geom, self.device = geom, torch.device(device)
        self.p = Weights(state, self.device, operand_rounding(precision))
        pin_float32()
        self.whole_points = grid_points(geom.space_size, geom.space_center, geom.voxels,
                                        self.device)

    @torch.no_grad()
    def __call__(self, heatmaps: torch.Tensor, cams: torch.Tensor) -> Dict[str, torch.Tensor]:
        """heatmaps (V, H, W, J) float32 and cams (V, 21) on the device ->
        per proposal slot (K): 'poses' (K, J, 3) mm, 'valid' (K,) bool,
        'confidence' (K,) the CPN's value, 'centres' (K, 3) mm."""
        g, p = self.geom, self.p
        K, J = g.max_people, heatmaps.shape[-1]
        X, Y, Z = g.voxels
        cube = project_layer(g, heatmaps, cams, self.whole_points).reshape(X, Y, Z, J)
        root = v2v(p, cube.permute(3, 0, 1, 2)[None], "cpn")[0, 0]
        values, flat = nms_topk(root, K)
        index = torch.stack([flat // (Y * Z), flat // Z % Y, flat % Z], -1).float()
        size = torch.tensor(g.space_size, device=self.device)
        centre = torch.tensor(g.space_center, device=self.device)
        n = torch.tensor(g.voxels, dtype=torch.float32, device=self.device)
        centres = index / (n - 1) * size + centre - size / 2.0
        valid = values > g.threshold

        cv = g.cube_voxels
        grids = [grid_points(g.cube_size, c.tolist(), cv, self.device) for c in centres]
        cubes = torch.stack([project_layer(g, heatmaps, cams, pts).reshape(*cv, J)
                             for pts in grids]).permute(0, 4, 1, 2, 3)
        y = v2v(p, cubes, "prn").reshape(K, J, -1)
        prob = torch.softmax(g.beta * y, dim=-1)
        poses = torch.stack([torch.stack([(prob[k] * grids[k][:, a]).sum(-1) for a in range(3)],
                                         -1) for k in range(K)])
        return {"poses": poses, "valid": valid, "confidence": values, "centres": centres}
