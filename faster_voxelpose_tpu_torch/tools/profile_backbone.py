"""The ResNet-50 backbone stage by stage on the card (counterpart of
scripts/profile_backbone.py):

    python3 -m faster_voxelpose_tpu_torch.tools.profile_backbone [TAGS] [--images V,H,W] [--folded] [--device cpu]

TAGS is a comma-separated subset of stem, l1, l2, l3, l4, deconv, final,
full, s2d, s2dslice, padc8, k8, fusedpool (default all).  The stages are
the served backbone's own submodules (`models/resnet.py`: conv1 + bn1 +
ReLU + max pool, layer1_* .. layer4_*, the three deconvs with their
BatchNorms, the final conv, then the whole module), one PoseResNet-50 in
bf16 seeded with 0, each timed alone at the Panoptic bench shapes (V = 5
views of 512 x 960) on inputs of its own shape drawn from RandomState(0),
by `tools.timing.scan_slope` between 2 and 10 steps (the script's
slope(n1=2, n2=10); the scan body adds 1e-30 of the carry to the input
and sums the output's [:, 0, 0, 0], as the script's).  With --folded the
backbone's BatchNorms are folded into its convolutions first
(`PoseResNet.fold`), as `PoseService` serves it.

The candidates are the script's stem rewrites (:186-292), each computing
what the JAX candidate computes, with weights of its own: s2d (2 x 2
space-to-depth, a 4 x 4 stride-1 conv on 12 channels, SAME padding),
s2dslice (the same by four strided slices), padc8 (input channels padded
to 8), k8 (the 7 x 7 kernel as 8 x 8) and fusedpool (the conv at stride 4,
no max pool; not weight-equivalent, a measure of the traffic).

FLOPs are the script's MAC model (`gf`, `bott_macs`, :115-158), twice the
multiply-adds, times V.  The peak is the card's: BF16_FLOPS = 989 TFLOP/s,
the H100 SXM's dense bf16 tensor-core rate (the script's 197 TFLOP/s is a
TPU v5e's and is not used).  Each line gives ms (the device's clock; the
host's on the CPU), TFLOP/s and the share of that peak, under a header
with the card's name and power limit; then the sum of the stages stem ..
final against full, and one JSON line of the readings.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import pin_float32, resolve_device
from ..models.blocks import BatchNorm, Conv
from ..models.resnet import PoseResNet
from .profile_stages import stage_step
from .timing import device_line, scan_slope

BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense
LENGTHS = (2, 10)
IMAGES = (5, 512, 960)  # V views of ih x iw
STAGES = ("stem", "l1", "l2", "l3", "l4", "deconv", "final")
CANDIDATES = ("s2d", "s2dslice", "padc8", "k8", "fusedpool")
TAGS = STAGES + ("full",) + CANDIDATES


def bott_macs(inp: int, planes: int, px_in: int, px_out: int, down: bool) -> int:
    """Multiply-adds of one bottleneck per image (the script's)."""
    m = inp * planes * px_in + 9 * planes * planes * px_out + planes * 4 * planes * px_out
    if down:
        m += inp * planes * 4 * px_out
    return m


def stage_macs(ih: int, iw: int) -> Dict[str, int]:
    """Per-image multiply-adds of each tag at an ih x iw input (the
    script's MAC model)."""
    px0 = (ih // 2) * (iw // 2)  # the stem conv's output
    px1 = (ih // 4) * (iw // 4)
    px2 = (ih // 8) * (iw // 8)
    px3 = (ih // 16) * (iw // 16)
    px4 = (ih // 32) * (iw // 32)
    m = {
        "stem": px0 * 7 * 7 * 3 * 64,
        "l1": bott_macs(64, 64, px1, px1, True) + 2 * bott_macs(256, 64, px1, px1, False),
        "l2": bott_macs(256, 128, px1, px2, True) + 3 * bott_macs(512, 128, px2, px2, False),
        "l3": bott_macs(512, 256, px2, px3, True) + 5 * bott_macs(1024, 256, px3, px3, False),
        "l4": bott_macs(1024, 512, px3, px4, True) + 2 * bott_macs(2048, 512, px4, px4, False),
        # deconv k4/s2: 4 effective taps per output pixel
        "deconv": 4 * 2048 * 256 * px3 + 4 * 256 * 256 * px2 + 4 * 256 * 256 * px1,
        "final": 256 * 15 * px1,
    }
    m["full"] = sum(m[s] for s in STAGES)
    m.update(s2d=px0 * 4 * 4 * 12 * 64, s2dslice=px0 * 4 * 4 * 12 * 64,
             padc8=px0 * 7 * 7 * 8 * 64, k8=px0 * 8 * 8 * 3 * 64,
             fusedpool=(px0 // 4) * 7 * 7 * 3 * 64)
    return m


def gf(macs: int, views: int) -> int:
    """FLOPs of V images (the script's `gf`)."""
    return macs * 2 * views


def space_to_depth(x: torch.Tensor, slices: bool = False) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4C, H/2, W/2), channel (dy * 2 + dx) * C + c as
    the script's reshape (or, with `slices`, its four strided slices)."""
    if slices:
        return torch.cat([x[:, :, dy::2, dx::2] for dy in (0, 1) for dx in (0, 1)], dim=1)
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // 2, 2, W // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(B, 4 * C, H // 2, W // 2)


class StemCandidate(nn.Module):
    """One of the script's stem candidates: images (B, 3, H, W) ->
    (B, 64, H/4, W/4), conv1 and bn1 named as the flax modules."""

    def __init__(self, kind: str, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if kind not in CANDIDATES:
            raise ValueError(f"unknown candidate {kind!r}; known: {', '.join(CANDIDATES)}")
        self.kind = kind
        cin, k, stride = {"s2d": (12, 4, 1), "s2dslice": (12, 4, 1), "padc8": (8, 7, 2),
                          "k8": (3, 8, 2), "fusedpool": (3, 7, 4)}[kind]
        # padding (before, after) of each spatial axis: SAME at stride 1 for
        # k4 is (1, 2); the script's explicit pads otherwise
        self.pads = {4: (1, 2), 7: (3, 3), 8: (3, 4)}[k]
        self.conv1 = Conv(cin, 64, k, dtype=dtype, stride=stride, padding=0, use_bias=False)
        self.bn1 = BatchNorm(64, dtype)
        nn.init.kaiming_normal_(self.conv1.weight, mode="fan_out", nonlinearity="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.bn1.dtype)
        if self.kind in ("s2d", "s2dslice"):
            x = space_to_depth(x, slices=self.kind == "s2dslice")
        elif self.kind == "padc8":
            x = F.pad(x, (0, 0, 0, 0, 0, 5))
        x = F.relu(self.bn1(self.conv1(F.pad(x, self.pads * 2))))
        return x if self.kind == "fusedpool" else F.max_pool2d(x, 3, 2, padding=1)


def stage_fns(backbone: PoseResNet) -> Dict[str, Callable[[torch.Tensor], torch.Tensor]]:
    """Each stage of the backbone as a function of its input (NCHW, the
    compute dtype; `full` takes the module's NHWC images)."""
    def layer(i):
        blocks = [getattr(backbone, n) for n in backbone.stages if n.startswith(f"layer{i}_")]

        def run(x):
            for b in blocks:
                x = b(x)
            return x
        return run

    return {"stem": backbone.stem, "l1": layer(1), "l2": layer(2), "l3": layer(3),
            "l4": layer(4), "deconv": backbone.upsample, "final": backbone.final,
            "full": backbone}


def input_shapes(V: int, ih: int, iw: int) -> Dict[str, Tuple[int, ...]]:
    """The input shape of each tag (the script's `in=` shapes, NCHW)."""
    s = {"stem": (V, 3, ih, iw), "l1": (V, 64, ih // 4, iw // 4),
         "l2": (V, 256, ih // 4, iw // 4), "l3": (V, 512, ih // 8, iw // 8),
         "l4": (V, 1024, ih // 16, iw // 16), "deconv": (V, 2048, ih // 32, iw // 32),
         "final": (V, 256, ih // 4, iw // 4), "full": (V, ih, iw, 3)}
    s.update({c: (V, 3, ih, iw) for c in CANDIDATES})
    return s


def profile(tags: Sequence[str], device: torch.device, images=IMAGES, lengths=LENGTHS,
            dtype: torch.dtype = torch.bfloat16, folded: bool = False) -> Dict[str, dict]:
    """{tag: readings} of each tag: ms (device clock on the card, host
    clock on the CPU), host_ms, FLOPs, TFLOP/s and share of BF16_FLOPS;
    the backbone folded first where `folded`."""
    V, ih, iw = images
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        backbone = PoseResNet(50, 15, dtype=dtype).eval().to(device)
        if folded:
            backbone.fold()
        candidates = {c: StemCandidate(c, dtype).eval().to(device)
                      for c in CANDIDATES if c in tags}
    fns = stage_fns(backbone)
    fns.update(candidates)
    shapes, macs = input_shapes(V, ih, iw), stage_macs(ih, iw)
    rng = np.random.RandomState(0)
    out = {}
    for tag in (t for t in TAGS if t in tags):
        x = torch.as_tensor(rng.rand(*shapes[tag]).astype(np.float32)).to(device)
        if tag not in ("full", "stem") and tag not in CANDIDATES:
            x = x.to(dtype)  # a stage inside the network takes the compute dtype
        fn = fns[tag]
        sliced = lambda a, f=fn: f(a)[:, 0, 0, 0]  # noqa: E731  (the script's slice)
        with torch.no_grad():
            s = scan_slope(stage_step(sliced, x), *lengths, device)
        ms = s.device_ms if s.device_ms is not None else s.host_ms
        flops = gf(macs[tag], V)
        # a rate and a share of the card's peak only from the card's clock
        tflops = None if s.device_ms is None else flops / max(ms, 1e-12) / 1e9
        out[tag] = {"ms": ms, "host_ms": s.host_ms, "device_ms": s.device_ms,
                    "shape": list(shapes[tag]), "gflop": flops / 1e9, "tflops": tflops,
                    "share_of_peak": None if tflops is None else tflops * 1e12 / BF16_FLOPS}
        del x
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("tags", nargs="?", default=None, help="comma-separated tags (default all)")
    p.add_argument("--images", default=",".join(map(str, IMAGES)), help="V,H,W (default 5,512,960)")
    p.add_argument("--device", default=None, help="default: the CUDA device (cpu: tests only)")
    p.add_argument("--lengths", default=None, help="F1,F2 in place of 2,10 (tests)")
    p.add_argument("--folded", action="store_true",
                   help="fold the BatchNorms into the convolutions first, as served")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    pin_float32()
    tags = TAGS if args.tags is None else tuple(args.tags.split(","))
    unknown = set(tags) - set(TAGS)
    if unknown:
        raise SystemExit(f"unknown tags {sorted(unknown)}; known: {', '.join(TAGS)}")
    images = tuple(int(n) for n in args.images.split(","))
    lengths = tuple(int(n) for n in args.lengths.split(",")) if args.lengths else LENGTHS
    res = profile(tags, device, images, lengths, folded=args.folded)
    print(f"{device_line(device)}; peak {BF16_FLOPS / 1e12:.0f} TFLOP/s (H100 SXM bf16 dense "
          f"tensor cores); bfloat16, V={images[0]} images of {images[1]}x{images[2]}"
          + ("; BatchNorm folded" if args.folded else ""))
    for tag, r in res.items():
        rate = ("host clock: no device rate" if r["tflops"] is None else
                f"{r['tflops']:7.2f} TFLOP/s, {r['share_of_peak'] * 100:5.1f}% of bf16 peak")
        print(f"{tag:9s} in={tuple(r['shape'])}: {r['ms']:8.4f} ms  ({r['gflop']:7.1f} GF, "
              f"{rate})", flush=True)
    line = dict(res)
    if all(s in res for s in STAGES):
        line["stage_sum_ms"] = sum(res[s]["ms"] for s in STAGES)
        full = res.get("full", {}).get("ms")
        print(f"stages stem..final sum {line['stage_sum_ms']:.4f} ms"
              + (f" against full {full:.4f} ms" if full is not None else ""))
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main(sys.argv[1:])
