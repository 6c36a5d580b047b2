"""A ViTPose's weights from a seed, made on the device.

No backbone weights are committed, so the ViTPose cell serves a backbone
drawn here, tensor by tensor from one generator on the device: linear
weights, the patch conv, the position embedding and the head normal at
the scales below, LayerNorm and BatchNorm near identity (none equal to it
outside the planted channels), so that a fault in their arithmetic shows.

A random transformer's heatmaps carry nothing the trained fusion weights
detect, so one path is planted for each joint j, whose mark in the frames
is a disk of one colour channel c at one level L (`weights.joint_mark`;
`traffic/frames.py`).  The residual stream's channels are laid out as

  planted   for each colour c, COPIES pairs: the patch conv's centre tap
            (the pixel at the token's heatmap cell's centre) carries
            p_c = (v_c - LEVEL_MID) / LEVEL_SCALE, v_c the pixel's uint8
            value, into one channel of the pair and -p_c into the other;
  constant  a fifth of the width: half at +CONST, half at -CONST (the
            patch conv's bias), so that every token's LayerNorm mean and
            deviation are fixed by them: the pairs' difference over
            2 x the deviation is p_c / SIGMA wherever a LayerNorm reads it;
  random    the rest.

The blocks' LayerNorms scale the constant channels by CONST_GAIN, so
their attention and MLP work on the token-dependent channels; the blocks
never write into the constant channels, write into the planted ones at
BLOCK_INTO_SIGNAL of their scale (so a fault anywhere in them moves the
answer), and into the random ones at about BLOCK_OUT a write.  After
`last_norm` the head makes a tent per joint from the pairs: the first
transposed conv (bilinear taps) gives z = (v_c - L) / delta and -z,
delta half the levels' spacing, and 1, the shifts taken from a constant
channel through the same taps (so the taps' lower sum at the frame's
border moves no zero), and its ReLU relu(z), relu(-z); the second
(bilinear taps) gives 1 - relu(z) - relu(-z) and its ReLU the tent
relu(1 - |z|), exactly 0 a level away whatever the rounding of the ramps
there (their BatchNorms the identity on these channels); the output conv
takes the tent at
`weights.SIGNAL_GAIN` less `weights.SIGNAL_BIAS`, and every other channel
at FINAL_STD.  A joint's disk then comes out as a blob in its own heatmap,
seen alike from every view.

Keys and shapes are those of the port's `ViTPose.state_dict()`; loading
them there checks both.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import torch

from .weights import BILINEAR, IMAGENET_MEAN, IMAGENET_STD, SIGNAL_BIAS, SIGNAL_GAIN, joint_mark

COPIES = 8  # pairs of planted channels per colour
CONST = 4.0  # magnitude of the constant channels
CONST_SHARE = 5  # one channel in CONST_SHARE is constant
CONST_GAIN = 0.05  # the blocks' LayerNorm gain on the constant channels
LEVEL_MID, LEVEL_SCALE = 140.0, 160.0  # p = (v - LEVEL_MID) / LEVEL_SCALE
RANDOM_STD = 0.1  # the random channels' scale after the patch embedding
POS_STD = 0.05  # the position embedding's, on the random channels
LOGIT_SPREAD = 1.5  # variance of a query's attention logits over the tokens
V_RMS = 0.5  # the values' scale
BLOCK_OUT = 0.03  # each attention and MLP write into a random channel
FC1_BIAS = 0.5  # fc1's pre-activations: N(0, 1) plus a bias of this deviation
GELU_RMS = 0.6  # the GELU's outputs' scale there
BLOCK_INTO_SIGNAL = 0.1  # the writes into the planted channels, of BLOCK_OUT
FINAL_STD = 0.001  # the output conv's random part
PATCH_PADDING = 2  # the patch conv's, the upstream's at every size


def widths(yaml: Mapping) -> dict:
    """The ViT's sizes from a configuration's YAML (its VIT section, the
    published ViTPose-H where a key is absent, as the port's defaults)."""
    v, d = yaml.get("VIT", {}), yaml["DATASET"]
    iw, ih = d["IMAGE_SIZE"]
    p = int(v.get("PATCH_SIZE", 16))
    C = int(v.get("EMBED_DIM", 1280))
    return {"dim": C, "depth": int(v.get("DEPTH", 32)), "heads": int(v.get("NUM_HEADS", 16)),
            "hidden": int(v.get("MLP_RATIO", 4)) * C, "patch": p, "pad": PATCH_PADDING,
            "tokens": (ih // p) * (iw // p),
            "deconv": [int(f) for f in v.get("NUM_DECONV_FILTERS", (256, 256))],
            "joints": int(d["NUM_JOINTS"])}


def vitpose_spec(yaml: Mapping) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(key, shape, kind) of every tensor; kind one of 'patch', 'pos',
    'qk', 'v', 'out', 'fc1', 'norm', 'deconv', 'final', 'bn' (the four
    BatchNorm tensors under one key) and '<kind>_bias'."""
    w = widths(yaml)
    C, H = w["dim"], w["hidden"]
    spec = [("pos_embed", (1, w["tokens"] + 1, C), "pos"),
            ("patch_embed.proj.weight", (C, 3, w["patch"], w["patch"]), "patch"),
            ("patch_embed.proj.bias", (C,), "patch_bias")]
    for i in range(w["depth"]):
        b = f"blocks.{i}"
        spec += [(f"{b}.norm1", (C,), "norm"),
                 (f"{b}.attn.qkv.weight", (3 * C, C), "qk"),
                 (f"{b}.attn.qkv.bias", (3 * C,), "qk_bias"),
                 (f"{b}.attn.proj.weight", (C, C), "out"),
                 (f"{b}.attn.proj.bias", (C,), "out_bias"),
                 (f"{b}.norm2", (C,), "norm"),
                 (f"{b}.mlp.fc1.weight", (H, C), "fc1"), (f"{b}.mlp.fc1.bias", (H,), "fc1_bias"),
                 (f"{b}.mlp.fc2.weight", (C, H), "out"), (f"{b}.mlp.fc2.bias", (C,), "out_bias")]
    spec.append(("last_norm", (C,), "norm"))
    cin = C
    for i, f in enumerate(w["deconv"], 1):
        spec += [(f"deconv{i}.weight", (cin, f, 4, 4), "deconv"), (f"deconv_bn{i}", (f,), "bn")]
        cin = f
    return spec + [("final.weight", (w["joints"], cin, 1, 1), "final"),
                   ("final.bias", (w["joints"],), "final_bias")]


def channels(dim: int):
    """(planted (3, COPIES, 2) channel indices, the +, then the - of each
    pair; constant (+ channels, - channels); the first random channel)."""
    planted = torch.arange(3 * COPIES * 2).reshape(3, COPIES, 2)
    n_const = dim // CONST_SHARE // 2
    first = planted.numel()
    plus = torch.arange(first, first + n_const)
    minus = torch.arange(first + n_const, first + 2 * n_const)
    return planted, (plus, minus), first + 2 * n_const


def _stream(dim: int, depth: int):
    """(channel counts: planted, constant, random; the random channels'
    expected variance halfway through the blocks)."""
    planted, _, first = channels(dim)
    return (planted.numel(), first - planted.numel(), dim - first,
            RANDOM_STD ** 2 + POS_STD ** 2 + depth * BLOCK_OUT ** 2)


def layer_norm_sigma(dim: int, depth: int) -> float:
    """The deviation that the constant channels fix in a LayerNorm over the
    residual stream, with the planted (p^2 about 0.5) and random channels'
    expected shares."""
    n_sig, n_const, n_rand, var = _stream(dim, depth)
    return math.sqrt((n_const * CONST ** 2 + n_sig * 0.5 + n_rand * var) / dim)


def block_input_norm(dim: int, depth: int) -> float:
    """The expected norm of a block LayerNorm's output: the planted and
    random channels over sigma, the constant ones at CONST_GAIN."""
    n_sig, n_const, n_rand, var = _stream(dim, depth)
    sigma = layer_norm_sigma(dim, depth)
    return math.sqrt((n_sig * 0.5 + n_rand * var + n_const * (CONST * CONST_GAIN) ** 2)
                     / sigma ** 2)


def vitpose_weights(yaml: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of a seeded, planted ViTPose of a configuration's
    YAML, float32 on `device`, drawn tensor by tensor."""
    w = widths(yaml)
    C = w["dim"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2**63))

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    h = block_input_norm(C, w["depth"])  # the norm a block's linears take in
    std = {"pos": POS_STD, "patch": RANDOM_STD / math.sqrt(3 * w["patch"] ** 2 * 2.5),
           "patch_bias": 0.05, "qk_bias": 0.1, "out_bias": 0.01, "fc1": 1.0 / h,
           "fc1_bias": FC1_BIAS, "final": FINAL_STD, "final_bias": 0.05}
    out: Dict[str, torch.Tensor] = {}
    for key, shape, kind in vitpose_spec(yaml):
        if kind in ("norm", "bn"):
            names = ("weight", "bias") if kind == "norm" else (
                "weight", "bias", "running_mean", "running_var")
            u = uniform((len(names),) + shape, 0.0, 1.0)
            out[f"{key}.weight"] = 0.9 + 0.2 * u[0]
            out[f"{key}.bias"] = 0.02 * (u[1] - 0.5)
            if kind == "bn":
                out[f"{key}.running_mean"] = 0.1 * (u[2] - 0.5)
                out[f"{key}.running_var"] = 0.8 + 0.4 * u[3]
        elif kind == "deconv":  # He-normal over the 2 x 2 taps that reach an output pixel
            out[key] = normal(shape, math.sqrt(2.0 / (shape[0] * 4)))
        elif kind == "out":  # proj over the values, fc2 over the GELU's outputs
            rms = V_RMS if shape[1] == C else GELU_RMS
            out[key] = normal(shape, BLOCK_OUT / (math.sqrt(shape[1]) * rms))
        elif kind == "qk":  # q and k, then v
            t = normal(shape, 1.0 / h)
            t[:2 * C] *= math.sqrt(LOGIT_SPREAD)
            t[2 * C:] *= V_RMS
            out[key] = t
        else:
            out[key] = normal(shape, std[kind])
    plant_signal(out, w)
    return out


def plant_signal(out: Dict[str, torch.Tensor], w: Mapping) -> None:
    """Write the planted paths into the drawn weights, in place."""
    C, J = w["dim"], w["joints"]
    planted, (plus, minus), first = channels(C)
    signal, const = planted.reshape(-1), torch.cat([plus, minus])
    kept = torch.cat([signal, const])
    dev = out["pos_embed"].device
    tap = w["patch"] // 2 - 1 + w["pad"]  # the tap at pixel 16 i + 7: the cell's centre
    k = torch.tensor(BILINEAR, device=dev)
    bilinear = torch.outer(k, k)
    sigma = layer_norm_sigma(C, w["depth"])
    with torch.no_grad():
        pe, pb = out["patch_embed.proj.weight"], out["patch_embed.proj.bias"]
        pe[kept] = 0.0
        out["pos_embed"][..., kept] = 0.0
        for c in range(3):
            # p = (255 (std x + mean) - LEVEL_MID) / LEVEL_SCALE of the normalised x
            gain = 255.0 * IMAGENET_STD[c] / LEVEL_SCALE
            bias = (255.0 * IMAGENET_MEAN[c] - LEVEL_MID) / LEVEL_SCALE
            for sign, ch in ((1.0, planted[c, :, 0]), (-1.0, planted[c, :, 1])):
                pe[ch, c, tap, tap] = sign * gain
                pb[ch] = sign * bias
        pb[plus], pb[minus] = CONST, -CONST
        for key in list(out):
            if key.endswith(("norm1.weight", "norm2.weight")):
                out[key][const] = CONST_GAIN
            elif key.endswith(("attn.proj.weight", "mlp.fc2.weight")):
                out[key][const] = 0.0
                out[key][signal] *= BLOCK_INTO_SIGNAL
            elif key.endswith(("attn.proj.bias", "mlp.fc2.bias")):
                out[key][kept] = 0.0
        one = plus[0]  # a constant channel: M / sigma after last_norm
        head_in = torch.cat([signal, one[None]])
        out["last_norm.weight"][head_in], out["last_norm.bias"][head_in] = 1.0, 0.0
        # the head, every shift taken through the bilinear taps from the
        # constant channel, so that the taps' lower sum at the frame's
        # border scales z and 1 - |z| and moves no zero: layer 1 gives
        # z (2j), -z (2j + 1), z = (v_c - L) / delta from the pairs'
        # difference (p_c / sigma, over 2 COPIES) less (L - LEVEL_MID) /
        # LEVEL_SCALE of the constant channel's CONST / sigma, and 1
        # (channel 2J); layer 2 gives 1 - relu(z) - relu(-z) (channel j)
        d1, d2, fin = out["deconv1.weight"], out["deconv2.weight"], out["final.weight"]
        d1[:, :2 * J + 1] = 0.0
        d2[:, :J] = 0.0
        d1[one, 2 * J] = sigma / CONST * bilinear
        for j in range(J):
            c, level, delta = joint_mark(j, J)
            for e, s in enumerate((1.0, -1.0)):
                r = 2 * j + e
                gain = s * LEVEL_SCALE * sigma / delta / (2 * COPIES)
                for pair_sign, ch in ((1.0, planted[c, :, 0]), (-1.0, planted[c, :, 1])):
                    d1[ch, r] = pair_sign * gain * bilinear
                d1[one, r] = -s * (level - LEVEL_MID) * sigma / (CONST * delta) * bilinear
                d2[r, j] = -bilinear
            d2[2 * J, j] = bilinear
        for bn, n in (("deconv_bn1", 2 * J + 1), ("deconv_bn2", J)):
            out[f"{bn}.weight"][:n], out[f"{bn}.bias"][:n] = 1.0, 0.0
            out[f"{bn}.running_mean"][:n], out[f"{bn}.running_var"][:n] = 0.0, 1.0 - 1e-5
        for j in range(J):
            fin[j, :J] = 0.0
            fin[j, j, 0, 0] = SIGNAL_GAIN
        out["final.bias"] -= SIGNAL_BIAS
