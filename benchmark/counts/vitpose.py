"""Work of a ViTPose from a configuration's shapes: multiply-adds of the
patch embedding, the blocks and the head (FLOPs = 2 x MACs; LayerNorm,
softmax, GELU, bias and residual work not counted), and the attention
kernel's operations and bytes."""

from __future__ import annotations

from typing import Mapping

from .flops import fusion_macs

PATCH_PADDING = 2


def _grid(yaml: Mapping):
    """(views, tokens per view, heatmap pixels per view) of the YAML."""
    d = yaml["DATASET"]
    p, pad = int(yaml.get("VIT", {}).get("PATCH_SIZE", 16)), PATCH_PADDING
    iw, ih = d["IMAGE_SIZE"]
    hp, wp = (ih + 2 * pad - p) // p + 1, (iw + 2 * pad - p) // p + 1
    return int(d["CAMERA_NUM"]), hp * wp, hp * wp


def vitpose_macs(yaml: Mapping) -> dict:
    """MACs of one view by part: 'patch', 'linear' (qkv, proj, fc1, fc2 of
    every block), 'attention' (q k^T and the weights times v of every
    block: 2 n^2 C), 'head' (the transposed convs, 4 taps reaching each
    output pixel, and the output conv)."""
    v = yaml.get("VIT", {})
    C = int(v.get("EMBED_DIM", 1280))
    depth = int(v.get("DEPTH", 32))
    hidden = int(v.get("MLP_RATIO", 4)) * C
    p = int(v.get("PATCH_SIZE", 16))
    _, n, px = _grid(yaml)
    head, cin = 0, C
    for f in v.get("NUM_DECONV_FILTERS", (256, 256)):
        px *= 4
        head += 4 * cin * int(f) * px
        cin = int(f)
    head += cin * int(yaml["DATASET"]["NUM_JOINTS"]) * px
    return {"patch": 3 * p * p * C * n,
            "linear": depth * n * C * (3 * C + C + 2 * hidden),
            "attention": depth * 2 * n * n * C,
            "head": head}


def request_flops(yaml: Mapping) -> float:
    """FLOPs of one served request: the ViTPose over every view and the
    fusion forward."""
    d, c, i = yaml["DATASET"], yaml["CAPTURE_SPEC"], yaml["INDIVIDUAL_SPEC"]
    views = int(d["CAMERA_NUM"])
    macs = views * sum(vitpose_macs(yaml).values())
    macs += fusion_macs(d["NUM_JOINTS"], c["VOXELS_PER_AXIS"], i["VOXELS_PER_AXIS"],
                        c["MAX_PEOPLE"])
    return 2.0 * macs


def attention_kernel(yaml: Mapping) -> dict:
    """One block's attention over every view of a request, one launch:
    operations 4 n^2 C a view (the two products), bytes of Q, K, V in and
    O out once each, bf16."""
    views, n, _ = _grid(yaml)
    C = int(yaml.get("VIT", {}).get("EMBED_DIM", 1280))
    return {"ops": views * 4 * n * n * C, "bytes": views * 4 * n * C * 2}


def least_seconds(work: dict, peaks: dict) -> float:
    """The larger of bytes over the memory bandwidth and operations over
    the bf16 tensor-core rate."""
    return max(work["bytes"] / peaks["hbm_bytes"], work["ops"] / peaks["bf16_flops"])
