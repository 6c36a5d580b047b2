"""Least work of the two sampling kernels of a request, from the shapes.

Bytes: each input byte read once, each output byte written once.
Operations (float32, off the tensor cores), per point and view: the
projection (translation 3, rotation 15, perspective 4, distortion 17,
intrinsics 4, clamp-free affine and rescale 10: 53), the bilinear weights
(8); per point, view and joint: 4 products and 4 sums of the corners;
per point and joint: the view mean and clamp (2), and for the crop the
mask and the three plane maxima (4)."""

from __future__ import annotations

PROJECT_OPS = 53
WEIGHT_OPS = 8


def whole_kernel(views: int, heatmap_hw, joints: int, voxels) -> dict:
    """The whole-space cube of one sample: heatmaps and rig in, cube out."""
    H, W = heatmap_hw
    n = voxels[0] * voxels[1] * voxels[2]
    bytes_ = 4 * (views * H * W * joints + views * 21 + n * joints)
    ops = n * views * (PROJECT_OPS + WEIGHT_OPS + 8 * joints) + 2 * n * joints
    return {"bytes": bytes_, "ops": ops}


def crop_kernel(views: int, heatmap_hw, joints: int, ind_voxels, max_people: int,
                live_voxels: int) -> dict:
    """The crop planes of one sample: heatmaps in, 3 planes of K slots
    out; operations over the voxels the masks keep."""
    H, W = heatmap_hw
    vx, vy, vz = ind_voxels
    planes = max_people * (vx * vy + vx * vz + vy * vz) * joints
    bytes_ = 4 * (views * H * W * joints + views * 21 + planes)
    ops = live_voxels * (views * (PROJECT_OPS + WEIGHT_OPS + 8 * joints) + 6 * joints)
    return {"bytes": bytes_, "ops": ops}


def least_seconds(work: dict, peaks: dict) -> float:
    """The larger of bytes over the memory bandwidth and operations over
    the float32 rate."""
    return max(work["bytes"] / peaks["hbm_bytes"], work["ops"] / peaks["fp32_flops"])
