"""Multiply-adds of the served networks, counted layer by layer from the
shapes (convolutions, transposed convolutions and dense layers; the
pooling, BatchNorm and elementwise work is not counted).  FLOPs are 2 x
MACs."""

from __future__ import annotations

from typing import Sequence


def _conv(cin, cout, k, rank, out_px):
    return cin * cout * k ** rank * out_px


def _res(cin, cout, rank, px):
    m = _conv(cin, cout, 3, rank, px) + _conv(cout, cout, 3, rank, px)
    return m + (_conv(cin, cout, 1, rank, px) if cin != cout else 0)


def unet_macs(cin: int, size: Sequence[int]) -> int:
    """The front (7-wide conv to 16, residual to 32) and the two-level
    encoder-decoder 32-64-128-64-32 on an input of spatial `size` (1 or 2
    axes), per sample."""
    rank = len(size)
    px = 1
    for s in size:
        px *= s
    px2, px4 = px // 2 ** rank, px // 4 ** rank
    m = _conv(cin, 16, 7, rank, px) + _res(16, 32, rank, px)
    m += _res(32, 32, rank, px) + _res(32, 64, rank, px2) + _res(64, 64, rank, px2)
    m += _res(64, 128, rank, px4) + 2 * _res(128, 128, rank, px4)
    m += 128 * 64 * px2 + _res(64, 64, rank, px2) + 64 * 32 * px  # k2/s2 upsamples
    return m


def fusion_macs(joints: int, voxels: Sequence[int], ind_voxels: Sequence[int],
                max_people: int) -> int:
    """One heatmaps -> poses forward: CenterNet on the X x Y map, C2CNet
    on K columns of Z, P2PNet on 3K planes and WeightNet on their 3K x J
    maps (the planes of a crop taken as 64 x 64 each, as at the published
    sizes where the crop is a cube)."""
    X, Y, Z = voxels
    vx, vy, _ = ind_voxels
    K, J = max_people, joints
    centre = unet_macs(J, (X, Y)) + 2 * _conv(32, 32, 3, 2, X * Y) + _conv(32, 1, 1, 2, X * Y)
    centre += _conv(32, 2, 1, 2, X * Y)
    height = K * (unet_macs(J, (Z,)) + _conv(32, 1, 1, 1, Z))
    planes = 3 * K * (unet_macs(J, (vx, vy)) + _conv(32, J, 1, 2, vx * vy))
    weights = 3 * K * J * (_conv(1, 32, 3, 2, vx * vy) + 32 * 64 + 64)
    return centre + height + planes + weights


def resnet50_macs(height: int, width: int, joints: int) -> int:
    """Pose-ResNet-50 on one height x width frame (strided layers "SAME":
    each halves a side, rounding up)."""
    def half(n):
        return -(-n // 2)

    h, w = half(height), half(width)
    m = _conv(3, 64, 7, 2, h * w)
    h, w = half(h), half(w)  # max-pool
    cin = 64
    for stage, (blocks, planes) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
        for b in range(blocks):
            if b == 0 and stage > 0:
                h2, w2 = half(h), half(w)
            else:
                h2, w2 = h, w
            m += cin * planes * h * w + 9 * planes * planes * h2 * w2
            m += planes * 4 * planes * h2 * w2
            if b == 0:
                m += cin * 4 * planes * h2 * w2
            h, w, cin = h2, w2, 4 * planes
    for _ in range(3):  # k4/s2 transposed: 4 taps reach each output pixel
        h, w = 2 * h, 2 * w
        m += 4 * cin * 256 * h * w
        cin = 256
    return m + 256 * joints * h * w


def request_flops(yaml, images: bool) -> float:
    """FLOPs of one served request of a configuration's YAML: the fusion
    forward, and the backbone over every view where frames come in."""
    d, c, i = yaml["DATASET"], yaml["CAPTURE_SPEC"], yaml["INDIVIDUAL_SPEC"]
    macs = fusion_macs(d["NUM_JOINTS"], c["VOXELS_PER_AXIS"], i["VOXELS_PER_AXIS"],
                       c["MAX_PEOPLE"])
    if images:
        iw, ih = d["IMAGE_SIZE"]
        macs += d["CAMERA_NUM"] * resnet50_macs(ih, iw, d["NUM_JOINTS"])
    return 2.0 * macs
