"""Faster-VoxelPose inference in plain PyTorch: heatmaps and a camera rig
in, every proposal's fused pose out.

Stages, as the paper and its code describe them:
1. whole-space projection: each voxel centre of the capture space is
   projected into every view (pinhole with radial and tangential
   distortion, then the original-image -> input -> heatmap frames), the
   heatmaps are sampled bilinearly (zeros outside), averaged over the
   views and clamped to [0, 1];
2. HDN: the cube's max over z, CenterNet (a 2D U-Net) to a centre map and
   a bbox-size map, 3x3 max-pool NMS, the top K, the column of the cube
   under each into C2CNet (a 1D U-Net) for the height; a proposal is
   valid when its 2D and 1D peaks multiply to more than MIN_SCORE;
3. JLN: for each proposal a 64^3 crop on the fine grid around it,
   projected and sampled as in 1, zeroed outside its predicted bbox,
   max-projected onto the xy, xz and yz planes; P2PNet (a 2D U-Net) per
   plane, soft-argmax at temperature BETA, WeightNet's per-joint weights
   and the weighted fusion of the two estimates of each axis.

Weights are read from the checkpoint's flax-layout arrays (kernels
(*k, in, out), transposed-conv kernels flipped).  Everything runs in
float32; `precision="fp8"` rounds the operands of every conv and dense
layer (`precision.py`) for the control.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .precision import operand_rounding

BN_EPS = 1e-5


@dataclass(frozen=True)
class Geometry:
    """The sizes the reference needs, read from a configuration's
    published YAML (`from_config`)."""

    views: int
    ori_image_size: Tuple[int, int]  # (w, h)
    image_size: Tuple[int, int]
    heatmap_size: Tuple[int, int]
    joints: int
    space_size: Tuple[float, float, float]
    space_center: Tuple[float, float, float]
    voxels: Tuple[int, int, int]
    max_people: int
    min_score: float
    ind_space_size: Tuple[float, float, float]
    ind_voxels: Tuple[int, int, int]
    beta: float

    @classmethod
    def from_config(cls, yaml: Mapping) -> "Geometry":
        d, c, i = yaml["DATASET"], yaml["CAPTURE_SPEC"], yaml["INDIVIDUAL_SPEC"]
        return cls(
            views=int(d["CAMERA_NUM"]), ori_image_size=tuple(d["ORI_IMAGE_SIZE"]),
            image_size=tuple(d["IMAGE_SIZE"]), heatmap_size=tuple(d["HEATMAP_SIZE"]),
            joints=int(d["NUM_JOINTS"]), space_size=tuple(map(float, c["SPACE_SIZE"])),
            space_center=tuple(map(float, c["SPACE_CENTER"])),
            voxels=tuple(c["VOXELS_PER_AXIS"]), max_people=int(c["MAX_PEOPLE"]),
            min_score=float(c["MIN_SCORE"]),
            ind_space_size=tuple(map(float, i["SPACE_SIZE"])),
            ind_voxels=tuple(i["VOXELS_PER_AXIS"]), beta=float(yaml["NETWORK"]["BETA"]),
        )

    @property
    def fine_voxels(self) -> Tuple[int, int, int]:
        """Voxels per axis of the fine grid that crops are cut from: the
        crop's spacing carried over the whole space (truncated)."""
        return tuple(int(s / i * (v - 1)) + 1 for s, i, v in
                     zip(self.space_size, self.ind_space_size, self.ind_voxels))


def resize_affine(ori: Sequence[int], out: Sequence[int]) -> np.ndarray:
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


def sample_views(geom: Geometry, heatmaps: torch.Tensor, cams: torch.Tensor,
                 points: torch.Tensor) -> torch.Tensor:
    """heatmaps (V, H, W, J), world points (N, 3) -> (N, J): the bilinear
    samples averaged over the views, clamped to [0, 1]."""
    px = project(points, cams).clamp(-1.0, float(max(geom.ori_image_size)))
    A = torch.as_tensor(resize_affine(geom.ori_image_size, geom.image_size),
                        dtype=torch.float32, device=points.device)
    x = px[..., 0] * A[0, 0] + px[..., 1] * A[0, 1] + A[0, 2]
    y = px[..., 0] * A[1, 0] + px[..., 1] * A[1, 1] + A[1, 2]
    (w, h), (iw, ih) = geom.heatmap_size, geom.image_size
    gx = x * (w / iw) / (w - 1) * 2 - 1
    gy = y * (h / ih) / (h - 1) * 2 - 1
    grid = torch.stack([gx, gy], dim=-1).clamp(-1.1, 1.1)[:, None]  # (V, 1, N, 2)
    vals = F.grid_sample(heatmaps.permute(0, 3, 1, 2), grid, mode="bilinear",
                         padding_mode="zeros", align_corners=True)  # (V, J, 1, N)
    return vals[:, :, 0].mean(0).clamp(0.0, 1.0).t()


def axis_points(size, center, n) -> torch.Tensor:
    return torch.linspace(-size / 2, size / 2, n, dtype=torch.float64) + center


def grid_points(size, center, voxels, device) -> torch.Tensor:
    """Voxel centres (X*Y*Z, 3), x slowest."""
    axes = [axis_points(s, c, n) for s, c, n in zip(size, center, voxels)]
    mesh = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([m.reshape(-1) for m in mesh], -1).float().to(device)


class Params:
    """The checkpoint's arrays under one module path, as float32 tensors
    in PyTorch's layouts."""

    def __init__(self, arrays: Mapping[str, np.ndarray], device, round_fn):
        self.a, self.device, self.q = arrays, device, round_fn
        self._cache: Dict[str, torch.Tensor] = {}

    def _get(self, path: str) -> torch.Tensor:
        if path not in self._cache:
            self._cache[path] = torch.as_tensor(np.asarray(self.a[path], np.float32),
                                                device=self.device)
        return self._cache[path]

    def conv(self, x, path, pad):
        w = self._get(f"params/{path}/kernel")
        r = w.ndim - 2
        w = w.permute(r + 1, r, *range(r))
        b = self._get(f"params/{path}/bias")
        f = F.conv2d if r == 2 else F.conv1d
        return f(self.q(x), self.q(w), self.q(b), padding=pad)

    def deconv(self, x, path):
        w = self._get(f"params/{path}/kernel")
        r = w.ndim - 2
        w = torch.flip(w, dims=tuple(range(r))).permute(r, r + 1, *range(r))
        b = self._get(f"params/{path}/bias")
        f = F.conv_transpose2d if r == 2 else F.conv_transpose1d
        return f(self.q(x), self.q(w), self.q(b), stride=2)

    def dense(self, x, path):
        w, b = self._get(f"params/{path}/kernel"), self._get(f"params/{path}/bias")
        return F.linear(self.q(x), self.q(w.t()), self.q(b))

    def bn(self, x, path):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mean = self._get(f"batch_stats/{path}/mean").reshape(shape)
        var = self._get(f"batch_stats/{path}/var").reshape(shape)
        g = self._get(f"params/{path}/scale").reshape(shape)
        b = self._get(f"params/{path}/bias").reshape(shape)
        return (x - mean) / torch.sqrt(var + BN_EPS) * g + b


def _pool(x):
    return F.max_pool2d(x, 2) if x.ndim == 4 else F.max_pool1d(x, 2)


def res_block(p: Params, x, path):
    h = F.relu(p.bn(p.conv(x, f"{path}/conv1", 1), f"{path}/bn1"))
    h = p.bn(p.conv(h, f"{path}/conv2", 1), f"{path}/bn2")
    if f"params/{path}/skip_conv/kernel" in p.a:
        x = p.bn(p.conv(x, f"{path}/skip_conv", 0), f"{path}/skip_bn")
    return F.relu(h + x)


def up_block(p: Params, x, path):
    return F.relu(p.bn(p.deconv(x, f"{path}/deconv"), f"{path}/bn"))


def unet(p: Params, x, path):
    """Front (7-wide conv, BN, ReLU; residual block to 32 channels) and
    the two-level encoder-decoder 32-64-128-64-32 with residual skips."""
    x = F.relu(p.bn(p.conv(x, f"{path}/front/front_basic/conv", 3),
                    f"{path}/front/front_basic/bn"))
    x = res_block(p, x, f"{path}/front/front_res")
    e = f"{path}/encdec"
    skip1 = res_block(p, x, f"{e}/skip_res1")
    x = res_block(p, _pool(x), f"{e}/encoder_res1")
    skip2 = res_block(p, x, f"{e}/skip_res2")
    x = res_block(p, _pool(x), f"{e}/encoder_res2")
    x = res_block(p, x, f"{e}/mid_res")
    x = up_block(p, res_block(p, x, f"{e}/decoder_res2"), f"{e}/decoder_upsample2") + skip2
    return up_block(p, res_block(p, x, f"{e}/decoder_res1"), f"{e}/decoder_upsample1") + skip1


def nms_topk(m: torch.Tensor, k: int):
    """A (X, Y) map's local maxima under a 3x3 window, the k largest
    (ties to the lower flat index): values and flat indices."""
    pooled = F.max_pool2d(m[None, None], 3, stride=1, padding=1)[0, 0]
    flat = torch.where(m == pooled, m, torch.zeros_like(m)).reshape(-1)
    values, order = torch.sort(flat, descending=True, stable=True)
    return values[:k], order[:k]


def crop_planes(geom: Geometry, heatmaps, cams, tl, bbox):
    """One proposal's three max planes (J, X, Y), (J, X, Z), (J, Y, Z) of
    its bbox-masked crop, and the number of voxels the mask keeps."""
    dev = heatmaps.device
    fine, vox = geom.fine_voxels, geom.ind_voxels
    size = torch.tensor(geom.space_size, dtype=torch.float32, device=dev)
    centre = torch.tensor(geom.space_center, dtype=torch.float32, device=dev)
    step = size / (torch.tensor(fine, dtype=torch.float32, device=dev) - 1)
    lo = centre - size / 2
    idx = [tl[a] + torch.arange(vox[a], device=dev) for a in range(3)]
    axes = [lo[a] + idx[a].float() * step[a] for a in range(3)]
    mesh = torch.meshgrid(*axes, indexing="ij")
    pts = torch.stack([m.reshape(-1) for m in mesh], -1)
    cube = sample_views(geom, heatmaps, cams, pts).reshape(*vox, -1)
    # the bbox (a fraction of the crop's x and y extent) and the space
    # bound the voxels kept
    keep = []
    for a in range(3):
        margin = 0
        if a < 2:
            margin = max(int((1.0 - float(bbox[a])) / 2.0 * (vox[a] - 1)), 0)
        start, end = max(int(tl[a]) + margin, 0), min(int(tl[a]) + vox[a] - margin, fine[a])
        keep.append((idx[a] >= start) & (idx[a] < end))
    mask = keep[0][:, None, None] & keep[1][None, :, None] & keep[2][None, None, :]
    cube = cube * mask[..., None]
    live = int(keep[0].sum()) * int(keep[1].sum()) * int(keep[2].sum())
    return (cube.amax(2).permute(2, 0, 1), cube.amax(1).permute(2, 0, 1),
            cube.amax(0).permute(2, 0, 1), live)


class FusionReference:
    """The model of one configuration and checkpoint on `device`."""

    def __init__(self, geom: Geometry, arrays: Mapping[str, np.ndarray], device,
                 precision: str = "float32"):
        self.geom, self.device = geom, torch.device(device)
        self.p = Params(arrays, self.device, operand_rounding(precision))
        self.whole_points = grid_points(geom.space_size, geom.space_center, geom.voxels,
                                        self.device)
        ind = grid_points(geom.ind_space_size, geom.space_center, geom.ind_voxels,
                          self.device).reshape(*geom.ind_voxels, 3)
        # soft-argmax coordinates of the xy, xz and yz planes, (3, P, 2)
        self.plane_grids = torch.stack([ind[:, :, 0, :2].reshape(-1, 2),
                                        ind[:, 0, :, 0::2].reshape(-1, 2),
                                        ind[0, :, :, 1:].reshape(-1, 2)])

    @torch.no_grad()
    def __call__(self, heatmaps: torch.Tensor, cams: torch.Tensor) -> Dict[str, torch.Tensor]:
        """heatmaps (V, H, W, J) float32 and cams (V, 21) on the device ->
        per proposal slot (K): 'poses' (K, J, 3) mm, 'valid' (K,) bool,
        'hdn_score' (K,), 'confidence' (K,), 'live_voxels' (K,) int (the
        voxels its bbox mask keeps), 'centres' (K, 3) mm, 'bbox' (K, 2)."""
        g, p = self.geom, self.p
        K, J = g.max_people, g.joints
        X, Y, Z = g.voxels
        cube = sample_views(g, heatmaps, cams, self.whole_points).reshape(X, Y, Z, J)

        x = unet(p, cube.amax(2).permute(2, 0, 1)[None], "hdn/center_net")
        cn = "hdn/center_net"
        centre_map = p.conv(F.relu(p.conv(x, f"{cn}/hm_conv", 1)), f"{cn}/hm_out", 0)[0, 0]
        size_map = p.conv(F.relu(p.conv(x, f"{cn}/size_conv", 1)), f"{cn}/size_out", 0)[0]
        conf2d, flat = nms_topk(centre_map, K)
        bbox = size_map.reshape(2, -1)[:, flat].t()  # (K, 2)
        cols = cube.reshape(X * Y, Z, J)[flat].permute(0, 2, 1)  # (K, J, Z)
        h = unet(p, cols, "hdn/c2c_net")
        hm1d = p.conv(h, "hdn/c2c_net/output", 0)[:, 0]  # (K, Z)
        conf1d, zi = hm1d.max(dim=1)
        score = conf2d * conf1d
        valid = score > g.min_score
        vox_idx = torch.stack([flat // Y, flat % Y, zi], -1).float()
        size = torch.tensor(g.space_size, device=self.device)
        centre = torch.tensor(g.space_center, device=self.device)
        vn = torch.tensor(g.voxels, dtype=torch.float32, device=self.device)
        centres = vox_idx * (size / (vn - 1)) + (centre - size / 2)

        # the crop's origin on the fine grid, as the published code maps it
        # (an affine in float32, rounded half to even: a proposal on the
        # space's edge lands on a half), and its offset in mm
        fine = torch.tensor(g.fine_voxels, dtype=torch.float32, device=self.device)
        ind = torch.tensor(g.ind_space_size, device=self.device)
        f64 = np.asarray(g.fine_voxels, np.float64) - 1
        sz, ctr = np.asarray(g.space_size), np.asarray(g.space_center)
        scale = f64 / sz
        bias = -np.asarray(g.ind_space_size) / 2.0 / sz * f64 - scale * (ctr - sz / 2.0)
        tl = torch.round(centres * torch.tensor(scale, dtype=torch.float32, device=self.device)
                         + torch.tensor(bias, dtype=torch.float32, device=self.device)).long()
        offset = tl.float() / (fine - 1) * size - size / 2 + ind / 2

        vx, vy, vz = g.ind_voxels
        planes = [torch.zeros((K, J, a, b), device=self.device)
                  for a, b in ((vx, vy), (vx, vz), (vy, vz))]
        live = torch.zeros(K, dtype=torch.long)
        # every slot goes through the JLN, so that a served person whose
        # slot the reference scores just under MIN_SCORE still has a pose
        # here to be paired with (in eval mode each slot is independent)
        for k in range(K):
            *pl, n = crop_planes(g, heatmaps, cams, tl[k], bbox[k])
            for plane, value in zip(planes, pl):
                plane[k] = value
            live[k] = n
        feats = p.conv(unet(p, torch.cat(planes), "jln/p2p_net"), "jln/p2p_net/output", 0)
        prob = torch.softmax(g.beta * feats.reshape(3, K, J, -1), dim=-1)
        confidence = prob.amax(-1).mean(dim=(0, 2))
        est = (prob[..., None] * self.plane_grids[:, None, None]).sum(-2)  # (3, K, J, 2)
        est = est + torch.stack([offset[:, None, 0:2], offset[:, None, 0::2],
                                 offset[:, None, 1:3]])
        w = self._plane_weights(feats).reshape(3, K, J)
        xs = (w[0] * est[0, ..., 0] + w[1] * est[1, ..., 0]) / (w[0] + w[1])
        ys = (w[0] * est[0, ..., 1] + w[2] * est[2, ..., 0]) / (w[0] + w[2])
        zs = (w[1] * est[1, ..., 1] + w[2] * est[2, ..., 1]) / (w[1] + w[2])
        return {"poses": torch.stack([xs, ys, zs], -1), "valid": valid, "hdn_score": score,
                "confidence": confidence, "live_voxels": live, "centres": centres,
                "bbox": bbox}

    def _plane_weights(self, feats):
        """WeightNet: per (plane, slot, joint) map a 3x3 conv to 32
        channels, BN, 2x2 max-pool, ReLU, global mean, two dense layers,
        sigmoid."""
        p = self.p
        M, J, H, W = feats.shape
        x = p.bn(p.conv(feats.reshape(M * J, 1, H, W), "jln/weight_net/feat_conv", 1),
                 "jln/weight_net/feat_bn")
        x = F.relu(F.max_pool2d(x, 2)).mean(dim=(2, 3))
        x = p.dense(F.relu(p.dense(x, "jln/weight_net/fc1")), "jln/weight_net/fc2")
        return torch.sigmoid(x)
