"""Work of MvP from a configuration's shapes: multiply-adds of one request
(FLOPs = 2 x MACs; the dense layers, the convolutions and the attention
products; BatchNorm, LayerNorm, softmax, rays and the sampling not counted
there), and the work of the projective attention kernel, counted the same
whatever implements it."""

from __future__ import annotations

from typing import List, Mapping, Tuple

from .flops import resnet50_macs

POSE_MLP_LAYERS = 3
TRUNK_HALVINGS = 5  # the ResNet trunk's stride 32, each halving rounding up
CORNERS = 4
BF16_BYTES = 2


def feature_sizes(yaml: Mapping) -> List[Tuple[int, int]]:
    """(H_l, W_l) of the three transposed convs' outputs for the
    configuration's frames."""
    w, h = yaml["DATASET"]["IMAGE_SIZE"]
    for _ in range(TRUNK_HALVINGS):
        w, h = -(-w // 2), -(-h // 2)
    levels = len(yaml.get("RESNET", {}).get("NUM_DECONV_FILTERS", [256] * 3))
    return [(h << (lv + 1), w << (lv + 1)) for lv in range(levels)]


def _widths(yaml: Mapping) -> dict:
    d, c, m = yaml["DATASET"], yaml["CAPTURE_SPEC"], yaml["MVP"]
    filters = yaml.get("RESNET", {}).get("NUM_DECONV_FILTERS", [256] * 3)
    return {"V": int(d["CAMERA_NUM"]), "J": int(d["NUM_JOINTS"]), "N": int(c["MAX_PEOPLE"]),
            "d": int(m["D_MODEL"]), "M": int(m["NUM_HEADS"]), "ff": int(m["DIM_FEEDFORWARD"]),
            "layers": int(m["DEC_LAYERS"]), "P": int(m["DEC_N_POINTS"]),
            "C": int(filters[-1]), "L": len(filters)}


def mvp_macs(yaml: Mapping) -> dict:
    """MACs of one request by part: 'trunk' (the Pose-ResNet-50 over every
    view to its transposed convs, no output conv), 'values' (RayConv and
    the value projection over every feature pixel) and 'decoder' (query
    adaptation, first references, the layers and the heads)."""
    w = _widths(yaml)
    V, J, N, d, M, ff, C = (w[k] for k in ("V", "J", "N", "d", "M", "ff", "C"))
    L, P, layers = w["L"], w["P"], w["layers"]
    iw, ih = yaml["DATASET"]["IMAGE_SIZE"]
    sizes = feature_sizes(yaml)
    H4, W4 = sizes[-1]
    trunk = V * (resnet50_macs(ih, iw, J) - 256 * J * H4 * W4)
    pixels = V * sum(h * w_ for h, w_ in sizes)
    values = pixels * ((C + 3) * d + d * d)
    Q = N * J
    layer = (Q * d * 3 * d + 2 * Q * Q * d + Q * d * d  # self-attention
             + Q * d * M * L * P * 3  # offsets (2 per tap) and weight logits (1)
             + V * Q * d * d + Q * V * d * d  # output_proj per view, the views' fusion
             + 2 * Q * d * ff  # FFN
             + Q * (2 * d * d + 3 * d))  # the pose MLP
    decoder = C * d + Q * d * 3 + layers * layer + Q * d  # + the last class head
    return {"trunk": trunk, "values": values, "decoder": decoder}


def request_flops(yaml: Mapping) -> float:
    """FLOPs of one served request."""
    return 2.0 * sum(mvp_macs(yaml).values())


def projattn_kernel(yaml: Mapping) -> dict:
    """One launch of the projective attention (one decoder layer): its taps
    (queries x views x heads x levels x points), the bytes it must move
    (each tap's 4 corners x Dh channels of bf16 read once, the offsets and
    logits float32 in, the output bf16 out) and its operations (2 per
    corner and channel, and 2 per tap and channel for the weighting)."""
    w = _widths(yaml)
    Q, Dh = w["N"] * w["J"], w["d"] // w["M"]
    taps = Q * w["V"] * w["M"] * w["L"] * w["P"]
    per_query = w["M"] * w["L"] * w["P"]
    bytes_ = (taps * CORNERS * Dh * BF16_BYTES + Q * per_query * 3 * 4
              + w["V"] * Q * w["d"] * BF16_BYTES)
    return {"taps": taps, "bytes": bytes_, "ops": taps * Dh * (2 * CORNERS + 2)}


def least_seconds(work: dict, peaks: dict) -> float:
    """The larger of the bytes over the memory bandwidth and the operations
    over the bf16 peak."""
    return max(work["bytes"] / peaks["hbm_bytes"], work["ops"] / peaks["bf16_flops"])
