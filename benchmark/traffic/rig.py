"""The demo camera ring (frozen copy of `make_rig` of the repo's
`scripts/make_demo_data.py`), packed as (V, 21) float32: R row-major,
T, fx, fy, cx, cy, k1..k3, p1, p2."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def make_rig(n_views: int, radius_mm: float, height_mm: float, center: Sequence[float],
             image_size: Sequence[int], seed: int = 0) -> np.ndarray:
    """n_views cameras on a circle of radius_mm around center (xy), at
    height_mm, each looking at the centre 1 m up; f = 0.9 image width."""
    rng = np.random.RandomState(seed)
    rows = []
    for v in range(n_views):
        angle = 2 * np.pi * v / n_views + rng.uniform(-0.1, 0.1)
        pos = np.array([center[0] + radius_mm * np.cos(angle),
                        center[1] + radius_mm * np.sin(angle), height_mm])
        fwd = np.array([center[0], center[1], 1000.0]) - pos
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        f = 0.9 * image_size[0]
        rows.append(np.concatenate([np.stack([right, down, fwd]).ravel(), pos,
                                    [f, f, image_size[0] / 2.0, image_size[1] / 2.0],
                                    np.zeros(5)]))
    return np.asarray(rows, np.float32)


def project_np(points: np.ndarray, cam: np.ndarray) -> np.ndarray:
    """World (N, 3) -> pixels (N, 2) for one packed camera, float64."""
    cam = np.asarray(cam, np.float64)
    xc = cam[0:9].reshape(3, 3) @ (np.asarray(points, np.float64) - cam[9:12]).T
    y = xc[:2] / (xc[2] + 1e-5)
    k, p = cam[16:19], cam[19:21]
    r2 = (y ** 2).sum(0)
    d = 1 + k[0] * r2 + k[1] * r2 ** 2 + k[2] * r2 ** 3
    u = y[0] * d + 2 * p[0] * y[0] * y[1] + p[1] * (r2 + 2 * y[0] ** 2)
    v = y[1] * d + 2 * p[1] * y[0] * y[1] + p[0] * (r2 + 2 * y[1] ** 2)
    return np.stack([u * cam[12] + cam[14], v * cam[13] + cam[15]], 1)
