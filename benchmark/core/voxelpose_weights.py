"""VoxelPose's weights from a seed, made on the device.

No VoxelPose weights are committed, so the VoxelPose cell serves a CPN
and a PRN drawn here, tensor by tensor from one generator on the device.
Every layer is random at a stated scale:

  conv1 of each residual branch  He-normal (std sqrt(2 / fan_in));
  conv2 of each residual branch  BRANCH x He-normal, so a branch writes
                                 about BRANCH of its block's input;
  1^3 projection skips           normal over their fan-in (unit gain),
                                 BRANCH of that into the planted channels;
  the transposed convs           BRANCH x normal over their fan-in: the
                                 encoder-decoder's way back adds about
                                 BRANCH of the signal to skip_res1/2's;
  the 7^3 front conv, the output random parts at BRANCH over their fan-in;
  1^3 conv
  biases                         normal at BIAS_STD;
  BatchNorms                     gain 0.9..1.1, shift +-0.01, running
                                 mean +-0.05, running variance 0.8..1.2.

A random V2VNet's output carries nothing of the scene, so one path is
planted for each joint channel j, through the layers that keep a voxel's
place: the 7^3 front conv's centre tap (1 from input channel j to output
channel j), the front residual block's 1^3 skip (1 from j to j), the
identity skip of skip_res1, and the output 1^3 conv (1 from j to output
j; in the CPN from ROOT_JOINT_ID's channel to its one output); the
BatchNorms after the planted convs are the identity on the planted
channels (gain 1, shift 0, mean 0, variance 1).  Every other branch
writes into those channels at the scales above, so that a fault in any
convolution moves the answer.  So the CPN's root cube is the root joint's
heatmaps sampled into the space, plus about BRANCH of everything else,
and peaks at each person's root above THRESHOLD; the PRN's cube of joint
j peaks at each joint j in its 2 m cube, which the soft-argmax at BETA
100 finds.

Keys and shapes are those of the port's `VoxelPoseNet.state_dict()`;
loading them there checks both.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import torch

BRANCH = 0.1  # what a residual branch or the way back writes, of the signal
BIAS_STD = 0.01
ROOT_FALLBACK = 2  # ROOT_JOINT_ID of Panoptic's 15 joints


def _res(prefix: str, cin: int, cout: int) -> List[Tuple[str, tuple, str]]:
    spec = [(f"{prefix}.conv1", (cout, cin, 3, 3, 3), "conv1"), (f"{prefix}.bn1", (cout,), "bn"),
            (f"{prefix}.conv2", (cout, cout, 3, 3, 3), "conv2"), (f"{prefix}.bn2", (cout,), "bn")]
    if cin != cout:
        spec += [(f"{prefix}.skip_conv", (cout, cin, 1, 1, 1), "skip"),
                 (f"{prefix}.skip_bn", (cout,), "bn")]
    return spec


def v2v_spec(prefix: str, cin: int, cout: int) -> List[Tuple[str, tuple, str]]:
    """(layer, weight shape, kind) of a V2VNet's layers, kind one of
    'front', 'conv1', 'conv2', 'skip', 'deconv', 'output' (a weight and a
    bias each) and 'bn' (its four tensors)."""
    f, e = f"{prefix}.front", f"{prefix}.encdec"
    spec = [(f"{f}.front_basic.conv", (16, cin, 7, 7, 7), "front"),
            (f"{f}.front_basic.bn", (16,), "bn")]
    spec += _res(f"{f}.front_res", 16, 32)
    for name, a, b in (("skip_res1", 32, 32), ("encoder_res1", 32, 64), ("skip_res2", 64, 64),
                       ("encoder_res2", 64, 128), ("mid_res", 128, 128),
                       ("decoder_res2", 128, 128)):
        spec += _res(f"{e}.{name}", a, b)
    spec += [(f"{e}.decoder_upsample2.deconv", (128, 64, 2, 2, 2), "deconv"),
             (f"{e}.decoder_upsample2.bn", (64,), "bn")]
    spec += _res(f"{e}.decoder_res1", 64, 64)
    spec += [(f"{e}.decoder_upsample1.deconv", (64, 32, 2, 2, 2), "deconv"),
             (f"{e}.decoder_upsample1.bn", (32,), "bn"),
             (f"{prefix}.output", (cout, 32, 1, 1, 1), "output")]
    return spec


def root_joint(yaml: Mapping) -> int:
    """The CPN's planted input channel: ROOT_JOINT_ID (the first where it
    lists two)."""
    r = yaml["DATASET"].get("ROOT_JOINT_ID", ROOT_FALLBACK)
    return int(r[0] if isinstance(r, (list, tuple)) else r)


def voxelpose_weights(yaml: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of a seeded, planted VoxelPose of a configuration's
    YAML, float32 on `device`, drawn tensor by tensor."""
    J = int(yaml["DATASET"]["NUM_JOINTS"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2**63))

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    out: Dict[str, torch.Tensor] = {}
    for net, cout in (("cpn", 1), ("prn", J)):
        for key, shape, kind in v2v_spec(net, J, cout):
            if kind == "bn":
                out[f"{key}.weight"] = uniform(shape, 0.9, 1.1)
                out[f"{key}.bias"] = uniform(shape, -0.01, 0.01)
                out[f"{key}.running_mean"] = uniform(shape, -0.05, 0.05)
                out[f"{key}.running_var"] = uniform(shape, 0.8, 1.2)
                continue
            # k2 s2: one input voxel and one tap reach each output voxel
            fan = shape[0] if kind == "deconv" else shape[1] * math.prod(shape[2:])
            std = {"conv1": math.sqrt(2.0 / fan), "conv2": BRANCH * math.sqrt(2.0 / fan),
                   "skip": math.sqrt(1.0 / fan)}.get(kind, BRANCH * math.sqrt(1.0 / fan))
            out[f"{key}.weight"] = normal(shape, std)
            out[f"{key}.bias"] = normal(shape[1:2] if kind == "deconv" else shape[:1], BIAS_STD)
        plant(out, net, J, root_joint(yaml) if net == "cpn" else None)
    return out


def _identity_bn(out: Dict[str, torch.Tensor], key: str, n: int) -> None:
    out[f"{key}.weight"][:n] = 1.0
    out[f"{key}.bias"][:n] = 0.0
    out[f"{key}.running_mean"][:n] = 0.0
    out[f"{key}.running_var"][:n] = 1.0


def plant(out: Dict[str, torch.Tensor], net: str, joints: int, root) -> None:
    """The planted path of each joint channel through the V2VNet `net`:
    front centre tap, front residual skip, output conv (skip_res1's skip
    is the identity already); in the CPN only the `root` channel reaches
    the output."""
    f = f"{net}.front"
    n = min(joints, 16)
    idx = torch.arange(n)
    w = out[f"{f}.front_basic.conv.weight"]
    w[idx, idx, 3, 3, 3] += 1.0
    out[f"{f}.front_basic.conv.bias"][:n] = 0.0
    _identity_bn(out, f"{f}.front_basic.bn", n)
    w = out[f"{f}.front_res.skip_conv.weight"]
    w[:n] *= BRANCH  # on the planted channels the skip's random part writes at BRANCH
    w[idx, idx, 0, 0, 0] += 1.0
    out[f"{f}.front_res.skip_conv.bias"][:n] = 0.0
    _identity_bn(out, f"{f}.front_res.skip_bn", n)
    w = out[f"{net}.output.weight"]
    if root is None:
        w[idx, idx, 0, 0, 0] += 1.0
    else:
        w[0, root, 0, 0, 0] += 1.0
    out[f"{net}.output.bias"].zero_()
