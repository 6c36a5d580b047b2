"""MvP, the multi-view pose transformer (Wang, Zhang, Cai, Yan and Feng,
"Direct Multi-view Multi-person 3D Pose Estimation", NeurIPS 2021;
sail-sg/mvp lib/models/multi_view_pose_transformer.py and its projective
attention), served beside Faster VoxelPose and VoxelPose:
`models.build_fusion_model` returns it where `cfg.MODEL` is "mvp".  It
reads the Pose-ResNet's feature levels, not its heatmaps, so the service
serves it frames alone (`engine/service.py`).

With y in [0, 1]^3 the normalised capture space and world(y) = y * S + C
- S / 2 (CAPTURE_SPEC's size S and centre C):

- **Features.** F_v^l, the Pose-ResNet's l-th transposed conv's output
  after its BatchNorm and ReLU (`resnet.images_to_features`), at strides
  16, 8 and 4; no output conv.
- **Values** (`values`). RayConv: r_v^l(u), the unit world-frame ray
  R_v^T K_v^-1 [u, 1] through each feature pixel's centre mapped back
  through the view's resize affine (distortion ignored); X_v^l =
  Linear_{C+3 -> d}([F_v^l ; r_v^l]), one layer for every level; then
  Val_v^l = value_proj(X_v^l), d -> d, in M heads of d / M channels.  One
  value projection is computed once and read by every decoder layer.
- **Queries.** e_{n,j} = h_n + g_j from an instance embedding (N, 2d) and
  a joint embedding (J, 2d), split into the query position p (first d) and
  the target t (last d); query adaptation t += Linear_{C -> d}(the mean
  of F^0 over views and pixels); the first reference y^0 =
  sigmoid(Linear_{d -> 3}(p)).
- **Decoder layer** (`DecoderLayer`), Deformable DETR's post-norm order:
  t <- LN(t + MHA(t + p, t + p, t)) over all N * J queries; projective
  attention: z = t + p, offsets Linear(z) -> (M, L, P, 2) and weight
  logits Linear(z) -> (M, L, P) (softmax over (L, P) per head, the same
  for every view), each view's s_{v,m} by `ops.projattn_kernels.
  projective_attention` (the query's y projected into view v by the
  port's projection, normalised by the input size, the taps at u +
  offset / (W_l, H_l), grid_sample semantics), o_v = output_proj(concat_m
  s_{v,m}) for every view, o = Linear_{V d -> d}(concat_v o_v)
  (`fuse_view_feats: cat_proj`), t <- LN(t + o); t <- LN(t + FFN(t)),
  FFN ReLU.
- **Refinement.** After layer i, y <- sigmoid(inverse_sigmoid(y, 1e-5) +
  MLP_3(t)), each layer with a pose MLP and a class head of its own, as
  Deformable DETR's refinement clones them (only the last class head is
  read).
- **Output.** The joints world(y^L); person score = the mean over joints
  of sigmoid(class_head_L(t)); valid where it is at least
  CAPTURE_SPEC.MIN_SCORE.  Faster VoxelPose's `fused5` layout (B, N, J,
  5): xyz mm, flag 0 or -1, the score, which `PoseService._decode` reads
  as it is; `proposal_centers` (B, N, 5): each person's mean joint, flag,
  score.

Precision.  The compute dtype (bf16 as served) for the values, the
queries and the residual stream; matmuls on its operands with float32
sums; LayerNorm and the softmaxes with float32 statistics; the offsets,
the weight logits and the refinement's last layer with float32 sums and
outputs (`blocks.Dense`, `float32_out`); y in float32; the first
reference points' layer and the class heads in float32, weights too:
in bf16 their own roundings set most of the answer's distance from
float32 (the first references' 35% of the joints', the class heads' half
of the scores'; reduced-size CPU runs), at 3 and 1 outputs a layer.  For
serving, `FoldedModule.fold()` (label "mvp") prepares every weight once in
its layer's dtype (`blocks.fold_layers`; the LayerNorms cast and kept),
the query embeddings' sum and RayConv's split columns (`fold_extra`).  On
the card the projective attention runs in bf16 only: the kernel takes bf16
value maps.  Served only: train mode raises.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from ..geometry.transforms import get_resize_transform
from ..ops.projattn_kernels import ProjAttnGeometry, projective_attention
from ..utils import profiling
from .blocks import Dense, FoldedModule, keep, runs_folded
from .common import DTYPES, ModelOutputs

POSE_MLP_LAYERS = 3  # `pose_embed_layer`
LN_EPS = 1e-5
SIGMOID_EPS = 1e-5  # inverse_sigmoid's
TRUNK_STRIDE_LOG2 = 5  # the ResNet trunk halves each side five times, rounding up


def inverse_sigmoid(x: torch.Tensor, eps: float = SIGMOID_EPS) -> torch.Tensor:
    """Deformable DETR's inverse_sigmoid: log(x / (1 - x)), both clamped
    at eps."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def feature_sizes(image_size: Sequence[int], levels: int) -> List[Tuple[int, int]]:
    """(H_l, W_l) of the Pose-ResNet's transposed convs' outputs for
    frames of image_size (w, h): the trunk's "SAME" halvings, then one
    doubling per level."""
    w, h = image_size
    for _ in range(TRUNK_STRIDE_LOG2):
        w, h = -(-w // 2), -(-h // 2)
    return [(h << (lv + 1), w << (lv + 1)) for lv in range(levels)]


def ray_pixels(image_size: Sequence[int], affine: np.ndarray,
               sizes: Sequence[Tuple[int, int]]) -> np.ndarray:
    """The original-image pixel of every feature pixel's centre, levels
    concatenated, each in row order: (sum H_l W_l, 2) float32.  Pixel
    (i, j) of an H x W level is input pixel ((j + 0.5) iw / W, (i + 0.5)
    ih / H), mapped back through the resize affine (float64, then
    float32)."""
    iw, ih = image_size
    a = np.asarray(affine, np.float64).reshape(2, 3)
    inv = np.linalg.inv(a[:, :2])
    out = []
    for H, W in sizes:
        jj, ii = np.meshgrid((np.arange(W) + 0.5) * iw / W, (np.arange(H) + 0.5) * ih / H)
        q = np.stack([jj.ravel(), ii.ravel()], -1) - a[:, 2]
        out.append(q @ inv.T)
    return np.concatenate(out).astype(np.float32)


def weights_of(layer: Dense) -> Tuple[torch.Tensor, torch.Tensor]:
    """A layer's weight and bias as its forward uses them: the folded ones
    where it runs folded, else its parameters cast."""
    if runs_folded(layer, False):
        return layer.folded_weight, layer.folded_bias
    dt, out = layer.dtype, layer.out_dtype
    return layer.weight.to(dt).to(out), layer.bias.to(dt).to(out)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm in the compute dtype (float32 statistics inside torch's
    kernels), on its folded weights where it was folded."""
    if getattr(norm, "folded", False) and not norm.training:
        w, b = norm.folded_weight, norm.folded_bias
    else:
        w, b = norm.weight.to(dtype), norm.bias.to(dtype)
    return F.layer_norm(x, (x.shape[-1],), w, b, LN_EPS)


class PoseMLP(nn.Module):
    """Deformable DETR's MLP: Linear, ReLU, ..., the last Linear's sums and
    output float32."""

    def __init__(self, d: int, out: int, dtype: torch.dtype):
        super().__init__()
        self.layers = nn.ModuleList(
            [Dense(d, d, dtype) for _ in range(POSE_MLP_LAYERS - 1)]
            + [Dense(d, out, dtype, float32_out=True)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        return self.layers[-1](x)


class DecoderLayer(nn.Module):
    """One decoder layer: self-attention, projective attention over the
    views, FFN, each with a residual and a LayerNorm after it."""

    def __init__(self, d: int, heads: int, ff: int, levels: int, points: int, views: int,
                 dtype: torch.dtype):
        super().__init__()
        if d % heads:
            raise ValueError(f"d_model {d} is not a multiple of {heads} heads")
        self.heads, self.levels, self.points, self.dtype = heads, levels, points, dtype
        self.in_proj = Dense(d, 3 * d, dtype)  # q, k, v stacked, as nn.MultiheadAttention
        self.out_proj = Dense(d, d, dtype)
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.sampling_offsets = Dense(d, heads * levels * points * 2, dtype, float32_out=True)
        self.attention_weights = Dense(d, heads * levels * points, dtype, float32_out=True)
        self.output_proj = Dense(d, d, dtype)
        self.fuse = Dense(views * d, d, dtype)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)
        self.linear1 = Dense(d, ff, dtype)
        self.linear2 = Dense(ff, d, dtype)
        self.norm3 = nn.LayerNorm(d, eps=LN_EPS)

    def self_attention(self, t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """MHA(t + p, t + p, t): q scaled by Dh^-1/2, softmax in float32."""
        B, Q, d = t.shape
        H = self.heads
        w, b = weights_of(self.in_proj)
        qk = F.linear(t + p, w[:2 * d], b[:2 * d]).view(B, Q, 2, H, d // H).permute(2, 0, 3, 1, 4)
        v = F.linear(t, w[2 * d:], b[2 * d:]).view(B, Q, H, d // H).transpose(1, 2)
        scores = (qk[0] * (d // H) ** -0.5) @ qk[1].transpose(-1, -2)  # (B, H, Q, Q)
        a = torch.softmax(scores.float(), dim=-1).to(t.dtype)
        return self.out_proj((a @ v).transpose(1, 2).reshape(B, Q, d))

    def forward(self, t, p, y, values, cams, geom: ProjAttnGeometry) -> torch.Tensor:
        B, Q, d = t.shape
        dt = self.dtype
        t = layer_norm(self.norm1, t + self.self_attention(t, p), dt)
        z = t + p
        M, L, P = self.heads, self.levels, self.points
        offsets = self.sampling_offsets(z).view(B, Q, M, L, P, 2)
        logits = self.attention_weights(z).view(B, Q, M, L, P)
        s = projective_attention(values, y, offsets, logits, cams, geom)  # (B, V, Q, d)
        o = self.fuse(self.output_proj(s).transpose(1, 2).reshape(B, Q, -1))
        t = layer_norm(self.norm2, t + o, dt)
        return layer_norm(self.norm3, t + self.linear2(F.relu(self.linear1(t))), dt)


class MvPNet(FoldedModule):
    """MvP in inference: the Pose-ResNet's feature levels (L tensors (B *
    V, C, H_l, W_l), views of a sample adjacent) and cams (B, V, 21) ->
    `ModelOutputs` (the module docstring).  A fresh module's layers are
    drawn as `blocks.Dense` draws them, the embeddings standard normal."""

    FOLD_LABEL = "mvp"
    READS = "features"  # what `PoseService` hands it: the backbone's levels

    def __init__(self, cfg: Config):
        super().__init__()
        m, d = cfg.MVP, cfg.MVP.D_MODEL
        filters = tuple(cfg.RESNET.NUM_DECONV_FILTERS)
        if len(set(filters)) != 1:
            raise ValueError(f"MvP reads feature levels of one width; deconv filters {filters}")
        self.dtype = dtype = DTYPES[cfg.NETWORK.COMPUTE_DTYPE]
        cs, ds = cfg.CAPTURE_SPEC, cfg.DATASET
        self.people, self.joints, self.views = cs.MAX_PEOPLE, ds.NUM_JOINTS, ds.CAMERA_NUM
        self.threshold, self.d_model, self.levels = cs.MIN_SCORE, d, len(filters)
        C = filters[0]
        affine = get_resize_transform(ds.ORI_IMAGE_SIZE, ds.IMAGE_SIZE)
        self.geom = ProjAttnGeometry.of(cs.SPACE_SIZE, cs.SPACE_CENTER, affine,
                                        ds.ORI_IMAGE_SIZE, ds.IMAGE_SIZE)
        self.sizes = feature_sizes(ds.IMAGE_SIZE, self.levels)
        # world(y) = y * size + lo on the device, as the kernel forms it
        self.register_buffer("space_size", torch.tensor(self.geom.size), persistent=False)
        self.register_buffer("space_lo", torch.tensor(self.geom.lo), persistent=False)
        self.register_buffer("ray_pixels",
                             torch.as_tensor(ray_pixels(ds.IMAGE_SIZE, affine, self.sizes)),
                             persistent=False)
        self.rayconv = Dense(C + 3, d, dtype)
        self.value_proj = Dense(d, d, dtype)
        self.instance_embed = nn.Parameter(torch.randn(self.people, 2 * d))
        self.joint_embed = nn.Parameter(torch.randn(self.joints, 2 * d))
        self.query_adapt = Dense(C, d, dtype)
        # the coordinates' and the scores' own heads stay float32, weights too
        # (they set the answer's rounding floor; 3 and 1 outputs)
        self.reference_points = Dense(d, 3, torch.float32)
        self.layers = nn.ModuleList(
            DecoderLayer(d, m.NUM_HEADS, m.DIM_FEEDFORWARD, self.levels, m.DEC_N_POINTS,
                         self.views, dtype) for _ in range(m.DEC_LAYERS))
        self.pose_embed = nn.ModuleList(PoseMLP(d, 3, dtype) for _ in range(m.DEC_LAYERS))
        self.class_embed = nn.ModuleList(Dense(d, 1, torch.float32) for _ in range(m.DEC_LAYERS))

    def fold_extra(self) -> List[torch.Tensor]:
        """Beside the layers' folded weights: the query embeddings e = h_n +
        g_j (N * J, 2d) in the compute dtype as `folded_query`, and
        RayConv's folded weight split into its feature and ray columns,
        each contiguous (`rayconv_feat`, `rayconv_ray`: a slice of the 259
        columns would make the GEMM over the feature pixels misaligned)."""
        keep(self, "folded_query", self._query_embed())
        w = self.rayconv.folded_weight
        keep(self, "rayconv_feat", w[:, :-3].contiguous())
        keep(self, "rayconv_ray", w[:, -3:].contiguous())
        return [self.instance_embed, self.joint_embed]

    def _query_embed(self) -> torch.Tensor:
        e = self.instance_embed[:, None] + self.joint_embed[None]
        return e.reshape(-1, e.shape[-1]).to(self.dtype)

    def rays(self, cams: torch.Tensor) -> List[torch.Tensor]:
        """The unit world-frame ray of every feature pixel in every view,
        (B, V, H_l W_l, 3) float32 per level: R^T ((x - cx) / fx, (y - cy)
        / fy, 1) at each pixel's original-image position, normalised."""
        c = cams[:, :, None]  # (B, V, 1, 21)
        pix = self.ray_pixels
        dx = (pix[:, 0] - c[..., 14]) / c[..., 12]
        dy = (pix[:, 1] - c[..., 15]) / c[..., 13]
        r = torch.stack([c[..., a] * dx + c[..., 3 + a] * dy + c[..., 6 + a] for a in range(3)],
                        dim=-1)
        r = r / r.norm(dim=-1, keepdim=True)
        return list(r.split([h * w for h, w in self.sizes], dim=2))

    def values(self, feats: Sequence[torch.Tensor], cams: torch.Tensor,
               served: bool = False) -> List[torch.Tensor]:
        """RayConv and the value projection of every level: (B, V, H_l,
        W_l, d) in the compute dtype; `served`, on the folded weights."""
        B, V = cams.shape[:2]
        if served:
            wf, wr, b = self.rayconv_feat, self.rayconv_ray, self.rayconv.folded_bias
        else:
            w, b = weights_of(self.rayconv)
            wf, wr = w[:, :-3], w[:, -3:]
        out = []
        for f, r in zip(feats, self.rays(cams)):
            H, W = f.shape[2:]
            x = f.to(self.dtype).permute(0, 2, 3, 1).reshape(-1, f.shape[1])
            x = torch.addmm(F.linear(r.reshape(-1, 3).to(wr.dtype), wr, b), x, wf.t())
            out.append(self.value_proj(x).view(B, V, H, W, self.d_model))
        return out

    def forward(self, feats: Sequence[torch.Tensor], cams: torch.Tensor,
                train: bool = False) -> ModelOutputs:
        """feats: L levels (B * V, C, H_l, W_l) in the compute dtype; cams
        (B, V, 21) float32."""
        if train or self.training:
            raise NotImplementedError("MvP is served here, not trained")
        served = self.serving(feats[0])  # refolds first where a tensor moved
        cams = cams.float().contiguous()
        B, V = cams.shape[:2]
        got = [tuple(f.shape[2:]) for f in feats]
        if got != [tuple(s) for s in self.sizes] or feats[0].shape[0] != B * V:
            raise ValueError(f"feature levels {got} of {feats[0].shape[0]} frames; MvP takes "
                             f"{self.sizes} of {B} x {V}")
        d, N, J = self.d_model, self.people, self.joints
        values = self.values(feats, cams, served)
        profiling.mark("values")  # a no-op except in a service's graph capture

        e = self.folded_query if served else self._query_embed()
        p, t = e[:, :d].expand(B, -1, -1), e[:, d:]
        f0 = feats[0].reshape(B, V, *feats[0].shape[1:]).float().mean(dim=(1, 3, 4))  # (B, C)
        t = t + self.query_adapt(f0.to(self.dtype))[:, None]
        y = torch.sigmoid(self.reference_points(p)).contiguous()  # (B, Q, 3) float32
        for layer, pose in zip(self.layers, self.pose_embed):
            t = layer(t, p, y, values, cams, self.geom)
            y = torch.sigmoid(inverse_sigmoid(y) + pose(t)).contiguous()
        score = torch.sigmoid(self.class_embed[-1](t)).view(B, N, J).mean(-1)  # (B, N)
        joints = (y * self.space_size + self.space_lo).view(B, N, J, 3)
        flag_score = torch.stack([(score >= self.threshold).float() - 1.0, score], dim=-1)
        fused5 = torch.cat([joints, flag_score[:, :, None].expand(-1, -1, J, -1)], dim=-1)
        return ModelOutputs(fused5, None, torch.cat([joints.mean(2), flag_score], dim=-1), None)


def build_mvp(cfg: Config) -> MvPNet:
    """The model in eval mode, for serving; it reads a Pose-ResNet's
    features (BACKBONE 'resnet')."""
    if cfg.BACKBONE != "resnet":
        raise ValueError(f"MvP reads the Pose-ResNet's feature levels; BACKBONE is "
                         f"{cfg.BACKBONE!r}")
    return MvPNet(cfg).eval()
