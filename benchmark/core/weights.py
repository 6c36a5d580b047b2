"""A Pose-ResNet-50's weights from a seed, made on the device.

No backbone weights are committed, so the image cells serve a backbone
drawn here: one normal draw for every kernel and one uniform draw for
every BatchNorm, on the device, then sliced and scaled.  Kernels are
He-normal over their fan-in (transposed kernels over the four taps that
reach each output pixel), so activations keep their scale through the
trunk; each bottleneck's last BatchNorm scales its branch by 0.2-0.4, so
the residual stream grows slowly over the 16 blocks; the other
BatchNorms hold statistics and affine terms near identity, none equal to
it outside the planted channels below, so that a fault in their
arithmetic shows.

A random backbone's heatmaps carry nothing the trained fusion weights
detect, so one path through the network is planted for each joint j:
the frames mark j with a disk of one colour channel at one level
(`joint_mark`; `traffic/frames.py`), the stem's centre tap and
BatchNorm turn that channel into three ramps relu((v - a) / delta) at
a = L - delta, L, L + delta (channels 3j..3j+2), every shortcut passes
those channels on unchanged (the identity, or the projection's 1x1 with
weight 1 on them and its BatchNorm the identity there), the three
transposed convolutions upsample them bilinearly, and the output layer takes r0 - 2 r1 + r2 (a
tent, 1 at v = L and 0 a level away) at `SIGNAL_GAIN` less
`SIGNAL_BIAS`.  A joint's disk then comes out as a blob in its own
heatmap, seen alike from every view, as a 2D detector's would.
Everything else is random and stays in the sums: the residual branches
write into the planted channels at `BRANCH_INTO_SIGNAL` of their scale,
and the other channels reach the output at `FINAL_STD`, so a fault
anywhere in the trunk moves the heatmaps.

Keys and shapes are those of the port's `PoseResNet.state_dict()`;
loading them there checks both.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

LAYOUT = (3, 4, 6, 3)
WIDTHS = (64, 128, 256, 512)
DECONV = 256
FINAL_STD = 0.001  # the output conv's random part
BRANCH_INTO_SIGNAL = 0.02  # residual branches' weight into the planted channels
SIGNAL_GAIN = 1.0
SIGNAL_BIAS = 0.1
BILINEAR = (0.25, 0.75, 0.75, 0.25)
IMAGENET_MEAN = (0.485, 0.456, 0.406)  # the port normalises frames with these
IMAGENET_STD = (0.229, 0.224, 0.225)
LEVEL_LO, LEVEL_HI = 60.0, 220.0  # the marks' levels; the background stays below


def joint_mark(joint: int, joints: int):
    """(RGB channel, level, delta) of joint's mark in the frames: channels
    in turn, levels evenly from LEVEL_LO to LEVEL_HI, delta half a level's
    spacing."""
    n = -(-joints // 3)
    step = (LEVEL_HI - LEVEL_LO) / max(n - 1, 1)
    return joint % 3, LEVEL_LO + step * (joint // 3), step / 2


def backbone_spec(joints: int) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(key, shape, kind) of every tensor, kind one of 'conv', 'deconv',
    'final', 'final_bias', 'bn', 'bn_last'."""
    spec: List[Tuple[str, Tuple[int, ...], str]] = [("conv1.weight", (64, 3, 7, 7), "conv")]
    spec.append(("bn1", (64,), "bn"))
    cin = 64
    for s, (blocks, w) in enumerate(zip(LAYOUT, WIDTHS)):
        for b in range(blocks):
            n = f"layer{s + 1}_{b}"
            spec += [(f"{n}.conv1.weight", (w, cin, 1, 1), "conv"), (f"{n}.bn1", (w,), "bn"),
                     (f"{n}.conv2.weight", (w, w, 3, 3), "conv"), (f"{n}.bn2", (w,), "bn"),
                     (f"{n}.conv3.weight", (4 * w, w, 1, 1), "conv"),
                     (f"{n}.bn3", (4 * w,), "bn_last")]
            if b == 0:
                spec += [(f"{n}.down_conv.weight", (4 * w, cin, 1, 1), "conv"),
                         (f"{n}.down_bn", (4 * w,), "bn")]
            cin = 4 * w
    for i in (1, 2, 3):
        spec += [(f"deconv{i}.weight", (cin, DECONV, 4, 4), "deconv"),
                 (f"deconv_bn{i}", (DECONV,), "bn")]
        cin = DECONV
    spec += [("final.weight", (joints, DECONV, 1, 1), "final"),
             ("final.bias", (joints,), "final_bias")]
    return spec


def _std(shape, kind) -> float:
    if kind == "conv":
        return math.sqrt(2.0 / (shape[1] * shape[2] * shape[3]))
    if kind == "deconv":  # 2 x 2 of the 4 x 4 taps reach each output pixel
        return math.sqrt(2.0 / (shape[0] * 4))
    if kind == "final":
        return FINAL_STD
    return 0.05  # final_bias


def backbone_weights(joints: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of a seeded Pose-ResNet-50 with `joints` outputs,
    float32 on `device`, in two draws."""
    spec = backbone_spec(joints)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2**63))
    tensors = [(k, s, kind) for k, s, kind in spec if not kind.startswith("bn")]
    norms = [(k, s, kind) for k, s, kind in spec if kind.startswith("bn")]
    n_w = sum(math.prod(s) for _, s, _ in tensors)
    n_bn = sum(4 * s[0] for _, s, _ in norms)
    flat = torch.randn(n_w, generator=gen, device=device)
    unif = torch.rand(n_bn, generator=gen, device=device)
    out, at = {}, 0
    for key, shape, kind in tensors:
        n = math.prod(shape)
        out[key] = (flat[at:at + n] * _std(shape, kind)).reshape(shape)
        at += n
    at = 0
    for key, shape, kind in norms:
        c = shape[0]
        u = unif[at:at + 4 * c].reshape(4, c)
        at += 4 * c
        lo, hi = (0.2, 0.4) if kind == "bn_last" else (0.8, 1.2)
        out[f"{key}.weight"] = lo + (hi - lo) * u[0]
        out[f"{key}.bias"] = 0.1 * (u[1] - 0.5)
        out[f"{key}.running_mean"] = 0.1 * (u[2] - 0.5)
        out[f"{key}.running_var"] = 0.8 + 0.4 * u[3]
    plant_signal(out, spec)
    return out


def plant_signal(w: Dict[str, torch.Tensor], spec) -> None:
    """Write the planted paths into the drawn weights, in place."""
    J = w["final.weight"].shape[0]
    n = 3 * J
    dev = w["conv1.weight"].device
    k = torch.tensor(BILINEAR, device=dev)
    with torch.no_grad():
        stem, bn = w["conv1.weight"], "bn1"
        stem[:n].zero_()
        for j in range(J):
            c, level, delta = joint_mark(j, J)
            gain = 255.0 * IMAGENET_STD[c] / delta  # uint8 units over delta
            for t, a in enumerate((level - delta, level, level + delta)):
                r = 3 * j + t
                stem[r, c, 3, 3] = gain
                w[f"{bn}.running_mean"][r] = gain * (a / 255.0 - IMAGENET_MEAN[c]) / IMAGENET_STD[c]
                w[f"{bn}.weight"][r], w[f"{bn}.bias"][r] = 1.0, 0.0
                w[f"{bn}.running_var"][r] = 1.0 - 1e-5
        for key, shape, kind in spec:
            if kind == "bn" and ("down_bn" in key or "deconv_bn" in key):
                w[f"{key}.weight"][:n], w[f"{key}.bias"][:n] = 1.0, 0.0
                w[f"{key}.running_mean"][:n], w[f"{key}.running_var"][:n] = 0.0, 1.0 - 1e-5
            elif kind == "bn_last":  # the branch's BatchNorm shifts no planted channel
                w[f"{key}.bias"][:n], w[f"{key}.running_mean"][:n] = 0.0, 0.0
            elif key.endswith("down_conv.weight"):
                w[key][:n].zero_()
                w[key][:n, :n, 0, 0] = torch.eye(n, device=dev)
            elif key.endswith(".conv3.weight"):
                w[key][:n] *= BRANCH_INTO_SIGNAL
            elif kind == "deconv":
                w[key][:, :n] = 0.0
                for r in range(n):
                    w[key][r, r] = torch.outer(k, k)
        fin = w["final.weight"]
        for j in range(J):
            fin[j, 3 * j:3 * j + 3, 0, 0] = torch.tensor((1.0, -2.0, 1.0), device=dev) * SIGNAL_GAIN
        w["final.bias"] -= SIGNAL_BIAS
