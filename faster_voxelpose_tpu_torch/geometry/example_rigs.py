"""Synthetic-but-realistic camera rigs for smoke runs, demos and tests
(counterpart of `faster_voxelpose_tpu/geometry/example_rigs.py`).

The Panoptic-like rig mirrors the real capture geometry: HD cameras on a
2.5-3.1 m dome ring looking at the space center, f~1450 px at 1920x1080,
mild radial + tangential distortion.  The sampling kernels' memory access
pattern depends on where the voxels project, so toy intrinsics would
distort a measurement.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def dome_camera(
    idx: int,
    n_views: int,
    space_center: Sequence[float] = (0.0, -500.0, 800.0),
    ori_image_size: Tuple[int, int] = (1920, 1080),
    focal: float = 1450.0,
    radius_range: Tuple[float, float] = (2500.0, 3100.0),
    height_range: Tuple[float, float] = (1200.0, 2400.0),
    seed: int = 100,
) -> dict:
    rng = np.random.RandomState(seed + idx)
    center = np.asarray(space_center, np.float64)
    angle = 2 * np.pi * idx / n_views + rng.uniform(-0.2, 0.2)
    radius = rng.uniform(*radius_range)
    height = rng.uniform(*height_range)
    pos = center + np.array(
        [radius * np.cos(angle), radius * np.sin(angle), height - center[2]]
    )

    fwd = center - pos
    fwd /= np.linalg.norm(fwd)
    up = np.array([0.0, 0.0, -1.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)  # world->cam rows

    w, h = ori_image_size
    return {
        "R": R,
        "T": pos.reshape(3, 1),
        "fx": focal + rng.uniform(-80, 80),
        "fy": focal + rng.uniform(-80, 80),
        "cx": w / 2.0 + rng.uniform(-30, 30),
        "cy": h / 2.0 + rng.uniform(-30, 30),
        "k": np.array([[-0.12], [0.05], [0.001]]),
        "p": np.array([[8e-4], [-5e-4]]),
    }


def dome_rig(
    B: int,
    n_views: int,
    **kwargs,
) -> np.ndarray:
    """Packed (B, V, 21) f32 rig of dome cameras (see dome_camera)."""
    from .cameras import pack_rig

    cams = [dome_camera(i, n_views, **kwargs) for i in range(n_views)]
    rig = pack_rig(cams).astype(np.float32)
    return np.broadcast_to(rig, (B, n_views, 21)).copy()


def perimeter_camera(
    idx: int,
    n_views: int,
    space_center: Sequence[float] = (3000.0, 4500.0, 1000.0),
    ori_image_size: Tuple[int, int] = (360, 288),
    focal: float = 430.0,
    radius_range: Tuple[float, float] = (8500.0, 12000.0),
    height_range: Tuple[float, float] = (2000.0, 3600.0),
    seed: int = 200,
) -> dict:
    """Campus-like wide-baseline outdoor camera: few views far outside a
    large (12x12m) capture area, a low-resolution sensor, a long working
    distance (the reference's Campus rig: 3 cameras, 360x288 images).  At
    this distance a voxel tile's image footprint is small, and the 12 m
    space projects people near the image border."""
    rng = np.random.RandomState(seed + idx)
    center = np.asarray(space_center, np.float64)
    angle = 2 * np.pi * idx / n_views + rng.uniform(-0.3, 0.3)
    radius = rng.uniform(*radius_range)
    height = rng.uniform(*height_range)
    pos = center + np.array(
        [radius * np.cos(angle), radius * np.sin(angle), height - center[2]]
    )

    fwd = center - pos
    fwd /= np.linalg.norm(fwd)
    up = np.array([0.0, 0.0, -1.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)

    w, h = ori_image_size
    return {
        "R": R,
        "T": pos.reshape(3, 1),
        "fx": focal + rng.uniform(-25, 25),
        "fy": focal + rng.uniform(-25, 25),
        "cx": w / 2.0 + rng.uniform(-10, 10),
        "cy": h / 2.0 + rng.uniform(-10, 10),
        "k": np.array([[-0.3], [0.12], [0.0]]),
        "p": np.array([[1e-3], [-1e-3]]),
    }


def perimeter_rig(B: int, n_views: int, **kwargs) -> np.ndarray:
    """Packed (B, V, 21) f32 rig of Campus-like perimeter cameras."""
    from .cameras import pack_rig

    cams = [perimeter_camera(i, n_views, **kwargs) for i in range(n_views)]
    rig = pack_rig(cams).astype(np.float32)
    return np.broadcast_to(rig, (B, n_views, 21)).copy()


def ring_rig(B: int, n_views: int) -> np.ndarray:
    """Packed (B, V, 21) f32 rig of the tiny profile's toy ring: V cameras
    evenly round the z axis, tilted 0.4 rad, 4000 mm from the origin,
    f = 260 px and c = (160, 120) at 320x240, no distortion (the JAX
    repo's `__graft_entry__._example_cameras`, bit for bit)."""
    from .cameras import pack_rig

    tilt = 0.4
    Rx = np.array(
        [
            [1, 0, 0],
            [0, np.cos(tilt), -np.sin(tilt)],
            [0, np.sin(tilt), np.cos(tilt)],
        ]
    )
    cams = []
    for v in range(n_views):
        angle = 2 * np.pi * v / n_views
        Rz = np.array(
            [
                [np.cos(angle), -np.sin(angle), 0],
                [np.sin(angle), np.cos(angle), 0],
                [0, 0, 1],
            ]
        )
        R = Rx @ Rz
        cams.append(
            {
                "R": R,
                "T": -R.T @ np.array([[0.0], [0.0], [4000.0]]),
                "fx": 260.0,
                "fy": 260.0,
                "cx": 160.0,
                "cy": 120.0,
                "k": np.zeros((3, 1)),
                "p": np.zeros((2, 1)),
            }
        )
    rig = pack_rig(cams).astype(np.float32)
    return np.broadcast_to(rig, (B, n_views, 21)).copy()
