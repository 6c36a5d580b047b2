"""MvP's weights from a seed, made on the device.

No MvP weights are committed, so the MvP cell serves a decoder drawn here,
tensor by tensor from one generator on the device, beside the planted
Pose-ResNet-50 of `core/weights.py` (its `final` is drawn but MvP does not
run it).  The draws follow the upstream's initialisation (Deformable
DETR's, which MvP keeps) with one change: no head is zero-initialised, so
that the decoder's answer depends on the images and a fault in any layer
moves it:

  linear layers               PyTorch's default, U(+-1/sqrt(fan_in)) for
                              weight and bias; the value, output and
                              attention in-projections xavier-uniform, their
                              biases U(+-1/sqrt(fan_in)) (the upstream: 0)
  LayerNorms                  gain 1 +- 0.1, shift +- 0.1 (the upstream:
                              identity)
  instance, joint embeddings  N(0, 1), as nn.Embedding
  sampling_offsets            bias: Deformable DETR's grid (head m's
                              direction at 2 pi m / M, point k at k + 1
                              feature pixels); weight N(0, (TAP_GAIN /
                              sqrt(d))^2) (the upstream: 0), so that a
                              query moves its taps by about a pixel
  attention_weights           N(0, (TAP_GAIN / sqrt(d))^2), bias U(+-0.1)
                              (the upstream: 0)
  reference_points            N(0, (REF_SPREAD / sqrt(d))^2), bias 0: the
                              first references lie about 1 m from the
                              space's centre along each floor axis (1.5-2
                              m in all on the mean), inside a studio's
                              ring of cameras (the upstream's xavier
                              spreads them over the whole 8 m space)
  each pose MLP's last layer  N(0, (POSE_STEP / sqrt(d))^2), bias 0 (the
                              upstream: 0), so that each layer's refinement
                              moves a joint by tens of mm
  class heads                 N(0, (CLASS_GAIN / sqrt(d))^2), bias
                              -log((1 - p) / p) at p = CLASS_PRIOR (the
                              upstream: 0.01), so that the person scores lie
                              about the 0.1 threshold (0-100% of a pool's
                              slots pass it, by seed)

POSE_STEP and TAP_GAIN set how strongly a layer's answer feeds back into
where the next layer samples, CLASS_GAIN how far a person's score moves
with the decoder's state.  Larger ones make the decoder chaotic: at
POSE_STEP 0.4, TAP_GAIN 1 and CLASS_GAIN 1, bf16 put the slots 68-81 mm
from the float32 reference on the card, half the fp8 control's 147-164 mm,
and the scores as far as the control's, so no limit could part them; the
bf16 error comes from the decoder's own roundings fed back through the
sampling positions, not from the backbone's.  At 0.15, 0.2 and 0.3 each
layer moves a joint 33-116 mm on the mean, the answers to two scenes lie
37-43 mm apart, and bf16 reads 3.7-5.8 mm (the largest slot 7.6) and score
gaps up to 0.0016 against the control's 61-83 mm and 0.0035-0.0078 (14
seeds on the card).  At POSE_STEP 0.06 bf16 read as close (2.6-3.5 mm), but
the answers to two scenes lay only 12-14 mm apart, so that a program
blind to its frames came within twice the limits (PERF.md §2).

Keys and shapes are those of the port's `MvPNet.state_dict()`; loading
them there checks both.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import torch

POSE_STEP = 0.15
TAP_GAIN = 0.2
CLASS_GAIN = 0.3
REF_SPREAD = 0.5
CLASS_PRIOR = 0.1
POSE_MLP_LAYERS = 3
DECONV = 256  # the Pose-ResNet's transposed convs' width, the features' channels


def mvp_spec(yaml: Mapping) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(key, shape, kind) of every tensor of a configuration's MvP."""
    d_, c, m = yaml["DATASET"], yaml["CAPTURE_SPEC"], yaml["MVP"]
    V, J, N = int(d_["CAMERA_NUM"]), int(d_["NUM_JOINTS"]), int(c["MAX_PEOPLE"])
    d, M, ff = int(m["D_MODEL"]), int(m["NUM_HEADS"]), int(m["DIM_FEEDFORWARD"])
    P, layers = int(m["DEC_N_POINTS"]), int(m["DEC_LAYERS"])
    filters = yaml.get("RESNET", {}).get("NUM_DECONV_FILTERS", [DECONV] * 3)
    C, L = int(filters[-1]), len(filters)

    def linear(name, cin, cout, kind="linear"):
        return [(f"{name}.weight", (cout, cin), kind), (f"{name}.bias", (cout,), "bias")]

    def norm(name):
        return [(f"{name}.weight", (d,), "ln_weight"), (f"{name}.bias", (d,), "ln_bias")]

    spec = linear("rayconv", C + 3, d) + linear("value_proj", d, d, "xavier")
    spec += [("instance_embed", (N, 2 * d), "embed"), ("joint_embed", (J, 2 * d), "embed")]
    spec += linear("query_adapt", C, d)
    spec += [("reference_points.weight", (3, d), "refs"), ("reference_points.bias", (3,), "zero")]
    for i in range(layers):
        n = f"layers.{i}"
        spec += linear(f"{n}.in_proj", d, 3 * d, "xavier") + linear(f"{n}.out_proj", d, d)
        spec += norm(f"{n}.norm1")
        spec += [(f"{n}.sampling_offsets.weight", (M * L * P * 2, d), "taps"),
                 (f"{n}.sampling_offsets.bias", (M * L * P * 2,), "grid"),
                 (f"{n}.attention_weights.weight", (M * L * P, d), "taps"),
                 (f"{n}.attention_weights.bias", (M * L * P,), "small")]
        spec += linear(f"{n}.output_proj", d, d, "xavier") + linear(f"{n}.fuse", V * d, d)
        spec += norm(f"{n}.norm2") + linear(f"{n}.linear1", d, ff) + linear(f"{n}.linear2", ff, d)
        spec += norm(f"{n}.norm3")
    for i in range(layers):
        for k in range(POSE_MLP_LAYERS - 1):
            spec += linear(f"pose_embed.{i}.layers.{k}", d, d)
        spec += [(f"pose_embed.{i}.layers.{POSE_MLP_LAYERS - 1}.weight", (3, d), "pose"),
                 (f"pose_embed.{i}.layers.{POSE_MLP_LAYERS - 1}.bias", (3,), "zero")]
    for i in range(layers):
        spec += [(f"class_embed.{i}.weight", (1, d), "class"),
                 (f"class_embed.{i}.bias", (1,), "prior")]
    return spec


def _grid(M: int, L: int, P: int, device) -> torch.Tensor:
    """Deformable DETR's sampling-offset bias, (M * L * P * 2,): head m's
    unit direction at 2 pi m / M, scaled so that its larger component is
    1, times k + 1 at point k, the same at every level."""
    theta = torch.arange(M, dtype=torch.float32, device=device) * (2.0 * math.pi / M)
    g = torch.stack([theta.cos(), theta.sin()], -1)
    g = g / g.abs().max(-1, keepdim=True).values
    k = torch.arange(1, P + 1, dtype=torch.float32, device=device)
    return (g[:, None, None, :] * k[None, None, :, None]).expand(M, L, P, 2).reshape(-1)


def mvp_weights(yaml: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of a seeded MvP of a configuration's YAML, float32
    on `device`, drawn tensor by tensor."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2**63))
    m = yaml["MVP"]
    d, M, P = int(m["D_MODEL"]), int(m["NUM_HEADS"]), int(m["DEC_N_POINTS"])
    L = len(yaml.get("RESNET", {}).get("NUM_DECONV_FILTERS", [DECONV] * 3))

    def uniform(shape, bound):
        return (2.0 * torch.rand(shape, generator=gen, device=device) - 1.0) * bound

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    out: Dict[str, torch.Tensor] = {}
    fan_in = {}
    for key, shape, kind in mvp_spec(yaml):
        if key.endswith(".weight") and len(shape) == 2:
            fan_in[key[:-len(".weight")]] = shape[1]
        layer = key.rsplit(".", 1)[0]
        if kind == "linear":
            t = uniform(shape, 1.0 / math.sqrt(shape[1]))
        elif kind == "xavier":
            t = uniform(shape, math.sqrt(6.0 / (shape[0] + shape[1])))
        elif kind == "bias":
            t = uniform(shape, 1.0 / math.sqrt(fan_in[layer]))
        elif kind == "ln_weight":
            t = 1.0 + uniform(shape, 0.1)
        elif kind in ("ln_bias", "small"):
            t = uniform(shape, 0.1)
        elif kind == "embed":
            t = normal(shape, 1.0)
        elif kind == "class":
            t = normal(shape, CLASS_GAIN / math.sqrt(d))
        elif kind == "taps":
            t = normal(shape, TAP_GAIN / math.sqrt(d))
        elif kind == "grid":
            t = _grid(M, L, P, device)
        elif kind == "refs":
            t = normal(shape, REF_SPREAD / math.sqrt(d))
        elif kind == "pose":
            t = normal(shape, POSE_STEP / math.sqrt(d))
        elif kind == "prior":
            t = torch.full(shape, -math.log((1.0 - CLASS_PRIOR) / CLASS_PRIOR), device=device)
        elif kind == "zero":
            t = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"unknown kind {kind!r} of {key}")
        out[key] = t.contiguous()
    return out
