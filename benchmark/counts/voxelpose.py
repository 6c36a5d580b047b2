"""Work of VoxelPose from a configuration's shapes: multiply-adds of its
two V2VNets (FLOPs = 2 x MACs; pooling, BatchNorm, NMS and soft-argmax
work not counted), and the bytes of the crop sampler's bounded cube mode."""

from __future__ import annotations

from typing import Mapping

from .flops import unet_macs


def voxelpose_macs(yaml: Mapping) -> dict:
    """MACs of one request by network: 'cpn', V2VNet(J, 1) on the
    whole space, and 'prn', V2VNet(J, J) on each of the K cubes."""
    d, c, i = yaml["DATASET"], yaml["CAPTURE_SPEC"], yaml["INDIVIDUAL_SPEC"]
    J, K = int(d["NUM_JOINTS"]), int(c["MAX_PEOPLE"])
    whole, cube = c["VOXELS_PER_AXIS"], i["VOXELS_PER_AXIS"]
    n_whole = whole[0] * whole[1] * whole[2]
    n_cube = cube[0] * cube[1] * cube[2]
    return {"cpn": unet_macs(J, whole) + 32 * 1 * n_whole,
            "prn": K * (unet_macs(J, cube) + 32 * J * n_cube)}


def request_flops(yaml: Mapping) -> float:
    """FLOPs of one served request: the CPN and the PRN over every slot."""
    return 2.0 * sum(voxelpose_macs(yaml).values())


def cube_kernel(yaml: Mapping) -> dict:
    """The crop sampler's bounded cube mode for one request: the heatmaps
    and the rig read once, the K cubes (K, X, Y, Z, J) float32 written."""
    d, c, i = yaml["DATASET"], yaml["CAPTURE_SPEC"], yaml["INDIVIDUAL_SPEC"]
    V, J, K = int(d["CAMERA_NUM"]), int(d["NUM_JOINTS"]), int(c["MAX_PEOPLE"])
    W, H = d["HEATMAP_SIZE"]
    X, Y, Z = i["VOXELS_PER_AXIS"]
    return {"bytes": 4 * (V * H * W * J + V * 21 + K * 3 + K * X * Y * Z * J)}


def least_seconds(work: dict, peaks: dict) -> float:
    """Bytes over the memory bandwidth."""
    return work["bytes"] / peaks["hbm_bytes"]
